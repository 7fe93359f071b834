"""Host-side block bookkeeping for the paged KV cache: free list,
refcounted block tables, and the copy-on-write prefix index.

The device side (the block pool, the scatter writes, the paged
flash-decode kernel) lives in :mod:`repro_torch.models.lm` and
:mod:`repro_torch.kernels`; this module owns the pure-Python free list and the
per-slot block tables the engine pushes to the device each decode step.

Physical block 0 is the **trash block**: it is never handed out, every
free slot's table points at it (tables are zeroed on retire), and the
ignored decode writes of free slots land there — so the pool can be
shared without a free slot ever corrupting a live one.

**Prefix sharing** (:class:`PrefixCache`) is the paper's hidden-dimension
argument applied to requests instead of layers: production prompts share
long prefixes (system prompts, few-shot templates, multi-turn history),
and the block-table indirection makes exploiting that a host-side move —
hash whole prompt blocks (chained, so a block's identity includes its
prefix), point a new request's table at matching physical blocks, skip
prefill for the cached tokens, and **copy-on-write** when a slot's write
would land in a block someone else can still read.  Blocks are
refcounted: a slot reference per table row pointing at the block plus
one retention reference while the index keeps it warm for future
requests ("lru" eviction; "none" drops a block's index entries the
moment its last reference goes).  Only a block whose refcount hits zero
returns to the free list.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class PoolExhausted(RuntimeError):
    """The request can never be served by this engine's block pool: its
    worst-case block need exceeds the pool (raised at ``submit`` — a
    too-small *current* free list just queues the request instead)."""


def blocks_for_request(prompt_len: int, max_new_tokens: int,
                       max_len: int, block_size: int) -> int:
    """Worst-case blocks a request can ever occupy: the cache holds the
    prompt plus every generated token except the last sampled one
    (which is never written), capped at the engine's ``max_len`` row
    budget."""
    tokens = min(prompt_len + max_new_tokens - 1, max_len)
    return -(-tokens // block_size)


class BlockAllocator:
    """Refcounted free list over ``num_blocks`` physical blocks plus the
    per-slot block tables (``(max_batch, pages)`` int32; entry 0 =
    unallocated / trash).

    Every mapped block carries a refcount: one reference per slot whose
    table points at it (the allocating slot is its *owner*; prefix-cache
    hits ``attach`` additional slots) plus an optional retention
    reference held by the :class:`PrefixCache`.  ``free_slot`` only
    drops the slot's references — a block returns to the free list the
    moment its refcount hits zero, and not before.  ``peak_in_use``
    tracks the high-water mark for the benchmark's ``peak_blocks_in_use``
    field."""

    def __init__(self, num_blocks: int, block_size: int, max_batch: int,
                 pages_per_slot: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 trash + 1 usable), "
                             f"got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.tables = np.zeros((max_batch, pages_per_slot), np.int32)
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> lowest id
        self._rc = np.zeros(num_blocks, np.int32)        # slot + retain refs
        self._owner = np.full(num_blocks, -1, np.int32)  # allocating slot
        self._retained = np.zeros(num_blocks, bool)      # PrefixCache ref
        self.peak_in_use = 0
        # hooks wired by the engine / PrefixCache: ``evict_hook(n)`` frees
        # up to n retained-only blocks, ``freed_hook(block)`` tells the
        # index a block it referenced left the pool
        self.evict_hook = None
        self.freed_hook = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def pinned_shared(self) -> int:
        """Blocks kept alive by slot references whose *owner* is gone —
        shared prefix blocks no active reservation pays for.  Admission
        must charge these against the pool capacity (the scheduler's
        ``free_block_budget`` subtracts them)."""
        slot_refs = self._rc - self._retained.astype(np.int32)
        return int(np.count_nonzero((self._owner < 0) & (slot_refs > 0)))

    def slot_blocks(self, slot: int) -> list[int]:
        row = self.tables[slot]
        return [int(b) for b in row if b]

    def refcount(self, block: int) -> int:
        return int(self._rc[block])

    # -------------------------------------------------------------- #
    def _release(self, block: int) -> None:
        self._rc[block] -= 1
        if self._rc[block] == 0:
            self._owner[block] = -1
            self._free.append(int(block))
            if self.freed_hook is not None:
                self.freed_hook(int(block))

    def _pop_free(self) -> int:
        if not self._free and self.evict_hook is not None:
            self.evict_hook(1)        # LRU retained-only block -> free
        if not self._free:
            raise PoolExhausted(
                f"KV block pool exhausted ({self.num_blocks - 1} usable "
                f"blocks, all referenced) — the scheduler's reservation "
                f"accounting should have prevented this")
        return self._free.pop()

    def alloc(self, slot: int, page: int) -> int:
        """Bind a fresh physical block to logical ``page`` of ``slot``
        (the slot becomes its owner, refcount 1)."""
        if self.tables[slot, page]:
            raise ValueError(f"slot {slot} page {page} already mapped to "
                             f"block {self.tables[slot, page]}")
        block = self._pop_free()
        self.tables[slot, page] = block
        self._rc[block] = 1
        self._owner[block] = slot
        self._retained[block] = False
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        return block

    def attach(self, slot: int, page: int, block: int) -> None:
        """Point ``page`` of ``slot`` at an existing (shared) ``block``:
        the prefix-cache hit path.  Takes a reference; the slot may read
        the block but must COW before writing into it."""
        if self.tables[slot, page]:
            raise ValueError(f"slot {slot} page {page} already mapped")
        if self._rc[block] <= 0:
            raise ValueError(f"attach to unreferenced block {block}")
        self.tables[slot, page] = block
        self._rc[block] += 1

    def ensure(self, slot: int, pos: int) -> tuple[int, int] | None:
        """Make the block holding token position ``pos`` of ``slot``
        safely *writable* — the lazy boundary-crossing allocation plus
        copy-on-write.  Unmapped page: bind a fresh block.  Mapped to a
        block this slot *owns*: nothing to do — even with readers
        attached or a retention reference held, because an owner only
        ever writes its own blocks while prefilling the very prompt
        content those references are for (a COW here would strand the
        readers on a block the publisher never fills).  Mapped to a
        block someone else owns or retains (a prefix-cache attach):
        allocate a fresh block, re-point the table, drop the shared
        reference, and return ``(src, dst)`` — the engine must copy the
        block's pool contents device-side before the write (skipping the
        degenerate ``src == dst`` case, where the release freed the
        block and the LIFO free list handed it straight back)."""
        page = pos // self.block_size
        block = int(self.tables[slot, page])
        if not block:
            self.alloc(slot, page)
            return None
        if self._owner[block] == slot:
            return None
        # copy-on-write: divergence inside a shared block
        self.tables[slot, page] = 0
        self._release(block)
        dst = self.alloc(slot, page)
        return (block, dst)

    def would_pin(self, block: int) -> bool:
        """True when attaching a slot to ``block`` would turn it into a
        pinned shared block (no owner, no reader yet — retained-only, or
        about to be resurrected): admission must charge for it."""
        slot_refs = self._rc[block] - int(self._retained[block])
        return bool(self._owner[block] < 0 and slot_refs == 0)

    # -------------------------------------------------------------- #
    def retain(self, block: int) -> None:
        """PrefixCache keeps ``block`` warm after its users retire."""
        if not self._retained[block]:
            self._retained[block] = True
            self._rc[block] += 1

    def release_retained(self, block: int) -> None:
        """Drop the index's retention reference (eviction / flush)."""
        if self._retained[block]:
            self._retained[block] = False
            self._release(block)

    def evictable(self, block: int) -> bool:
        """Only the index holds it — safe to evict without a reader."""
        return bool(self._retained[block]) and self._rc[block] == 1

    def free_slot(self, slot: int) -> int:
        """Drop all of ``slot``'s block references and point its table
        back at the trash block; returns the number of blocks that
        actually hit refcount 0 and rejoined the free list (shared /
        retained blocks live on)."""
        before = len(self._free)
        for page in range(self.tables.shape[1]):
            block = int(self.tables[slot, page])
            if not block:
                continue
            if self._owner[block] == slot:
                self._owner[block] = -1
            self._release(block)
        self.tables[slot, :] = 0
        return len(self._free) - before


def _block_hash(prev: int, tokens: tuple[int, ...]) -> int:
    """Chained content hash: a block's identity covers every token from
    position 0, so equal hashes mean equal *prefixes*, not just equal
    block contents at different depths."""
    return hash((prev, tokens))


class PrefixCache:
    """Content-addressed index over the block pool: chained whole-block
    prompt hashes -> physical block ids, refcounted through the
    allocator.

    ``match`` walks a prompt's full blocks down the chain and returns
    the leading run of cached physical blocks; ``register`` publishes a
    slot's freshly-allocated prompt block under its chain hash (first
    writer wins — a concurrent duplicate simply stays private).  With
    ``evict="lru"`` (default) every published block also carries a
    retention reference so it outlives its users — future requests with
    the same system prompt hit even with no concurrent sharer — and
    leaf-first LRU eviction hands blocks back when the allocator runs
    dry.  ``evict="none"`` keeps sharing purely concurrent: entries
    drop the moment their block's last reference goes.

    Publishing at *admission* (before the device write) is safe because
    the engine's prefill grant policy is oldest-first: a later-admitted
    request cannot execute a chunk that reads these blocks before the
    publishing slot — strictly older — has prefilled its whole prompt.
    """

    EVICTION = ("lru", "none")

    def __init__(self, alloc: BlockAllocator, *, evict: str = "lru"):
        if evict not in self.EVICTION:
            raise ValueError(f"unknown eviction policy {evict!r}; "
                             f"expected one of {self.EVICTION}")
        self.alloc = alloc
        self.block_size = alloc.block_size
        self.retain = evict == "lru"
        # hash -> (block, parent_hash, n_children); LRU order = insertion
        # order of the OrderedDict, refreshed on match
        self._entries: OrderedDict[int, list] = OrderedDict()
        self._by_block: dict[int, list[int]] = {}   # block -> [hashes]
        self.hits = 0              # requests that matched >= 1 block
        self.misses = 0            # requests that matched none
        self.tokens_saved = 0      # prompt tokens never re-prefilled
        self.evicted = 0
        alloc.evict_hook = self.evict
        alloc.freed_hook = self._on_block_freed

    @property
    def cached_blocks(self) -> int:
        return len({e[0] for e in self._entries.values()})

    def chain_hashes(self, prompt) -> list[int]:
        """The chained hash of every *full* block of ``prompt``."""
        bs = self.block_size
        hashes, prev = [], 0
        for start in range(0, len(prompt) - bs + 1, bs):
            prev = _block_hash(prev, tuple(prompt[start:start + bs]))
            hashes.append(prev)
        return hashes

    def match(self, prompt) -> list[int]:
        """Leading run of cached physical blocks for ``prompt`` (LRU
        refreshed on the whole matched chain).  Pure lookup: takes no
        references — the engine attaches the blocks it decides to use."""
        blocks = []
        for h in self.chain_hashes(prompt):
            entry = self._entries.get(h)
            if entry is None:
                break
            self._entries.move_to_end(h)
            blocks.append(entry[0])
        return blocks

    def register(self, prompt, page: int, block: int) -> bool:
        """Publish ``block`` as holding full prompt block ``page`` of
        ``prompt``.  First writer wins: an existing entry for the same
        chain hash keeps its block and the newcomer stays private."""
        hashes = self.chain_hashes(prompt)
        h = hashes[page]
        if h in self._entries:
            return False
        parent = hashes[page - 1] if page else None
        self._entries[h] = [block, parent, 0]
        self._by_block.setdefault(block, []).append(h)
        if parent is not None and parent in self._entries:
            self._entries[parent][2] += 1
        if self.retain:
            self.alloc.retain(block)
        return True

    # -------------------------------------------------------------- #
    def _drop_entry(self, h: int) -> None:
        block, parent, _ = self._entries.pop(h)
        hs = self._by_block.get(block)
        if hs is not None:
            hs.remove(h)
            if not hs:
                del self._by_block[block]
        if parent is not None and parent in self._entries:
            self._entries[parent][2] -= 1

    def _on_block_freed(self, block: int) -> None:
        """A block the index references rejoined the free list (only
        possible under evict="none", where entries hold no reference):
        its entries — and their now-unreachable descendants — must go."""
        for h in list(self._by_block.get(block, ())):
            self._drop_entries_from(h)

    def _drop_entries_from(self, h: int) -> None:
        doomed, frontier = [h], [h]
        while frontier:
            parents = set(frontier)
            frontier = [k for k, e in self._entries.items()
                        if e[1] in parents and k not in doomed]
            doomed.extend(frontier)
        for k in reversed(doomed):       # leaves first: child counts stay sane
            if k in self._entries:
                self._drop_entry(k)

    def evict(self, n: int = 1) -> int:
        """Free up to ``n`` retained-only blocks, oldest chains first and
        always leaf-inward (an interior block must outlive its children
        or the chain walk would dangle); returns the number freed."""
        freed = 0
        progress = True
        while freed < n and progress:
            progress = False
            for h in list(self._entries):            # LRU -> MRU
                block, _, children = self._entries[h]
                if children or not self.alloc.evictable(block):
                    continue
                self._drop_entry(h)
                if block not in self._by_block:      # last entry for it
                    self.alloc.release_retained(block)
                    freed += 1
                    self.evicted += 1
                progress = True
                break
        return freed

    def flush(self) -> int:
        """Drop every entry and retention reference (e.g. after a weight
        update invalidates all cached KV); returns the blocks freed."""
        free_before = self.alloc.free_blocks
        for h in list(self._entries):
            self._drop_entry(h)
        for block in list(self._by_block):
            del self._by_block[block]
        for block in range(1, self.alloc.num_blocks):
            self.alloc.release_retained(block)
        return self.alloc.free_blocks - free_before
