"""Host-side bookkeeping for the engine's KV slot pool (a copy of
``repro.serving.slots``).

The device half of a slot pool is a fixed-capacity
:class:`~repro_torch.core.spec_decode.DecodeState` (rows = slots, empty rows
are ``done``); this module tracks the host half: which request occupies
which slot, how many tokens it still owes, and the claim/retire lifecycle
the iteration-level scheduler (serving/scheduler.py) drives every
speculative step.

Paged KV (vLLM-style): :class:`BlockPool` is a free-list allocator of
fixed-size KV blocks and :class:`PagedKVTables` maps each slot to the list
of physical blocks holding its KV rows.  The same class is the host truth
for the live engine (which also consumes the concrete block ids) and the
count-exact mirror inside
:class:`~repro_torch.serving.scheduler.SimStepBackend`, so the scheduler's
preemption decisions — pure functions of (free blocks, per-slot tokens,
per-slot allocated blocks) — replay identically sim vs live.

Prefix sharing (copy-on-write; the index is
:class:`~repro_torch.serving.prefix_cache.PrefixCache`): every block carries
a reference count; ``alloc`` hands blocks out at refcount 1 and a block
enters the free list exactly when its count drops to 0
(``decref``/``release``), so the free set and the referenced set partition
the pool at all times.  A block with refcount > 1 is SHARED and must never
be written in place: writers go through
:meth:`PagedKVTables.cow_for_range`, which swaps a fresh copy into the
writing slot's table and drops the shared reference.  With a cache
attached, allocation under pressure evicts cache-only blocks LRU-first and
records their ids in ``evicted_pending`` so the live engine can wipe their
``pos`` rows before the blocks are handed out again (the standing "free
blocks carry pos = -1" invariant).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request


class BlockPoolExhausted(RuntimeError):
    """Raised when an allocation cannot be served from the free list.

    The scheduler is expected to preempt *before* this can happen; seeing it
    from the engine means admission/preemption accounting is out of sync.
    """


class BlockPool:
    """Free-list allocator of fixed-size KV blocks (the paged pool's core).

    Blocks are handed out lowest-id-first and the free list is kept sorted,
    so allocation is deterministic — a requirement for sim-vs-live parity of
    preemption decisions (both sides see the same free count at every step).

    Every block carries a reference count: 0 while on the free list, 1 when
    exclusively owned, > 1 when shared between slot tables and/or the prefix
    cache.  ``free`` is a bulk :meth:`decref` — a block only re-enters the
    free list when its last reference drops — so with no sharing the
    behavior is exactly the pre-refcount allocator.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # lowest-numbered block allocated first (pop from the tail)
        self._free = list(range(num_blocks - 1, -1, -1))
        self._refs = [0] * num_blocks

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` KV rows."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"requested {n} blocks, only {len(self._free)} free "
                f"(pool of {self.num_blocks}); the scheduler should have "
                f"preempted before this allocation")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block: int) -> int:
        """Add a reference to an allocated block; returns the new count."""
        if self._refs[block] < 1:
            raise RuntimeError(
                f"incref on free block {block}: references may only be "
                f"added to a block that is already owned")
        self._refs[block] += 1
        return self._refs[block]

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block became free."""
        if self._refs[block] < 1:
            raise RuntimeError(
                f"double-free of block {block} (refcount already 0)")
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)
            self._free.sort(reverse=True)
            return True
        return False

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def free(self, blocks: List[int]) -> List[int]:
        """Bulk :meth:`decref`; returns the blocks that actually became
        free (all of them when nothing is shared — the pre-refcount
        contract)."""
        freed = []
        for b in blocks:
            if self._refs[b] < 1:
                raise RuntimeError(
                    f"double-free of block {b} (refcount already 0)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                freed.append(b)
        if freed:
            self._free.extend(freed)
            self._free.sort(reverse=True)
        return freed

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks currently referenced more than once (shared)."""
        return sum(r > 1 for r in self._refs)

    @property
    def exclusive_count(self) -> int:
        """Blocks referenced exactly once (exclusively owned)."""
        return sum(r == 1 for r in self._refs)

    def check_invariants(self) -> None:
        """Raise AssertionError unless the free set and the referenced set
        partition the pool — the no-leak / no-double-free invariant the
        property suite asserts after every operation."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate id on the free list"
        assert self._free == sorted(free, reverse=True), \
            "free list not sorted descending"
        for b in range(self.num_blocks):
            if b in free:
                assert self._refs[b] == 0, \
                    f"block {b} is free but has refcount {self._refs[b]}"
            else:
                assert self._refs[b] >= 1, \
                    f"block {b} leaked: not free, refcount 0"
        assert len(free) + sum(r > 0 for r in self._refs) == self.num_blocks

    @staticmethod
    def _run_fragmentation(ids_desc: List[int]) -> float:
        """1 − (largest contiguous run / count) over a descending id list."""
        if not ids_desc:
            return 0.0
        best = run = 1
        for prev, cur in zip(ids_desc, ids_desc[1:]):
            run = run + 1 if prev == cur + 1 else 1
            best = max(best, run)
        return 1.0 - best / len(ids_desc)

    @property
    def fragmentation(self) -> float:
        """Free-list fragmentation in [0, 1]: one minus the largest
        contiguous free run over the total free count (0.0 when the free
        list is empty or a single run).  Block tables make any free block
        usable, so this is a telemetry gauge, not an allocator concern —
        it tracks how shuffled the pool has become under churn."""
        return self._run_fragmentation(self._free)


class PagedKVTables:
    """Per-slot block tables over a :class:`BlockPool`.

    Tracks, per slot, the physical blocks backing its KV rows and the number
    of tokens written so far (prompt + raw committed).  ``ensure`` grows a
    table block-by-block as the sequence grows — allocate-on-commit — and
    ``release`` drops one reference on every block on retire/preempt (with
    no sharing that frees them all — the pre-refcount contract).

    With a prefix cache attached
    (:meth:`attach_cache`), allocations that outrun the free list reclaim
    LRU cache-only blocks first; the evicted ids accumulate in
    ``evicted_pending`` until the live engine wipes their device ``pos``
    rows (sim backends just clear the list).  ``attach`` maps already-held
    cache blocks into a slot's table at refcount+1 and
    :meth:`cow_for_range` is the only legal way to make shared rows
    writable again.
    """

    def __init__(self, num_blocks: int, block_size: int, capacity: int,
                 max_blocks_per_slot: int):
        if max_blocks_per_slot < 1:
            raise ValueError("max_blocks_per_slot must be >= 1")
        if num_blocks < max_blocks_per_slot:
            # a lone maximal request must always fit, or the scheduler could
            # spin forever on a request it can never admit (every admitted
            # request is bounded by the per-slot cap, so this also makes the
            # preemption loop's "a single slot always fits" invariant hold)
            raise ValueError(
                f"num_blocks={num_blocks} < max_blocks_per_slot="
                f"{max_blocks_per_slot}: the pool could not hold even one "
                f"maximal request")
        self.pool = BlockPool(num_blocks, block_size)
        self.capacity = capacity
        self.max_blocks = max_blocks_per_slot
        self._tables: List[List[int]] = [[] for _ in range(capacity)]
        self._tokens = np.zeros(capacity, dtype=np.int64)
        # slots whose prefill is still being fed chunk-by-chunk: they hold
        # blocks but do not decode, so the per-step worst-case growth
        # (seq + s) must not be charged to them — the live engine and the
        # sim mirror both skip pending slots in their pre-step growth
        self._pending: set = set()
        # prefix cache (None = sharing disabled; exact legacy behavior)
        self.cache = None
        # cache blocks evicted by reclaim-under-pressure whose device pos
        # rows still hold stale entries; the live engine drains this list
        # (pos.at[ids].set(-1)) before the next dispatch that could hand
        # the ids back out, sim backends just clear it
        self.evicted_pending: List[int] = []
        self.evicted_total = 0

    # ------------------------------------------------------------------
    # geometry

    @property
    def block_size(self) -> int:
        return self.pool.block_size

    @property
    def num_blocks(self) -> int:
        return self.pool.num_blocks

    @property
    def free_blocks(self) -> int:
        return self.pool.free_count

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation can actually obtain: the free list plus
        the cache blocks that reclaim-under-pressure can evict (held by the
        cache alone, unlocked, with no descendant held elsewhere).  Every
        feasibility check in the scheduler uses this — with no cache
        attached it equals ``free_blocks`` exactly."""
        extra = self.cache.reclaimable() if self.cache is not None else 0
        return self.pool.free_count + extra

    @property
    def shared_blocks(self) -> int:
        """Blocks referenced more than once (slot tables and/or cache)."""
        return self.pool.shared_count

    @property
    def cached_blocks(self) -> int:
        """Blocks currently indexed by the attached prefix cache."""
        return self.cache.size if self.cache is not None else 0

    @property
    def fragmentation(self) -> float:
        """Free-list fragmentation gauge (see BlockPool.fragmentation).

        With a prefix cache attached the gauge is computed over the free
        list *plus* the reclaimable cache-only blocks: those are the ids an
        allocation can actually obtain, and the old free-list-only walk
        would misreport 0.0 fragmentation on a pool whose every available
        block sits (scattered) in the cache."""
        if self.cache is None:
            return self.pool.fragmentation
        ids = sorted(set(self.pool._free) | set(self.cache.reclaimable_ids()),
                     reverse=True)
        return BlockPool._run_fragmentation(ids)

    def attach_cache(self, cache) -> None:
        """Attach a prefix cache
        (:class:`~repro_torch.serving.prefix_cache.PrefixCache`) so
        allocations can reclaim LRU cache-only blocks under pressure."""
        if cache.pool is not self.pool:
            raise ValueError("prefix cache is bound to a different BlockPool")
        self.cache = cache

    @property
    def logical_len(self) -> int:
        """Per-slot logical capacity in tokens (block table fully grown)."""
        return self.max_blocks * self.pool.block_size

    def blocks_for(self, n_tokens: int) -> int:
        return self.pool.blocks_for(n_tokens)

    # ------------------------------------------------------------------
    # per-slot accounting

    def tokens(self, slot: int) -> int:
        return int(self._tokens[slot])

    def allocated(self, slot: int) -> int:
        return len(self._tables[slot])

    def table(self, slot: int) -> List[int]:
        return list(self._tables[slot])

    def active_slots(self) -> List[int]:
        return [i for i, t in enumerate(self._tables) if t]

    # ------------------------------------------------------------------
    # chunked-prefill (pending) slots

    def mark_pending(self, slot: int) -> None:
        """Flag ``slot`` as mid-chunked-prefill (holds blocks, not decoding)."""
        self._pending.add(slot)

    def clear_pending(self, slot: int) -> None:
        self._pending.discard(slot)

    def is_pending(self, slot: int) -> bool:
        return slot in self._pending

    # ------------------------------------------------------------------
    # lifecycle

    def _alloc(self, n: int) -> List[int]:
        """Pool allocation that reclaims LRU cache-only blocks when the
        free list alone cannot serve the request."""
        short = n - self.pool.free_count
        if short > 0 and self.cache is not None:
            evicted = self.cache.reclaim(short)
            if evicted:
                self.evicted_pending.extend(evicted)
                self.evicted_total += len(evicted)
        return self.pool.alloc(n)

    def prefill(self, slot: int, n_tokens: int) -> List[int]:
        """Allocate the blocks covering a fresh prompt in ``slot``."""
        if self._tables[slot]:
            raise RuntimeError(f"slot {slot} already holds blocks")
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks:
            raise ValueError(
                f"{n_tokens} tokens need {need} blocks > per-slot cap "
                f"{self.max_blocks}")
        blocks = self._alloc(need)
        self._tables[slot] = blocks
        self._tokens[slot] = n_tokens
        return blocks

    def attach(self, slot: int, blocks: List[int], n_tokens: int) -> None:
        """Map already-owned cache blocks into an empty slot's table.

        Each block gains a reference (the slot's own); the caller must
        already hold the blocks (the admission lock or the cache index), so
        they cannot have been evicted between match and attach.  The slot
        starts at ``n_tokens`` = blocks·block_size prefix rows; the suffix
        is fed afterwards through the normal ensure/commit chunk path.
        """
        if self._tables[slot]:
            raise RuntimeError(f"slot {slot} already holds blocks")
        if len(blocks) > self.max_blocks:
            raise ValueError(
                f"{len(blocks)} prefix blocks > per-slot cap {self.max_blocks}")
        if n_tokens != len(blocks) * self.block_size:
            raise ValueError(
                f"attach of {len(blocks)} blocks must cover exactly "
                f"{len(blocks) * self.block_size} tokens, got {n_tokens}")
        for b in blocks:
            self.pool.incref(b)
        self._tables[slot] = list(blocks)
        self._tokens[slot] = n_tokens

    def cow_for_range(self, slot: int, lo: int, hi: int) -> List[Tuple[int, int]]:
        """Make token rows [lo, hi) of ``slot`` writable: every shared
        block covering the range is swapped for a fresh exclusive copy.

        Returns (src, dst) pairs for the engine's block copy (host tables
        are updated here; device rows move on the
        engine).  Allocation happens before the decref, and a shared
        block's count stays ≥ 1 after it, so the source rows remain valid
        for the device copy.
        """
        if hi <= lo:
            return []
        pairs: List[Tuple[int, int]] = []
        table = self._tables[slot]
        # indices past the table are not allocated yet — ensure() will hand
        # them out fresh (exclusively owned), so they need no copy
        for bi in range(lo // self.block_size,
                        min(self.blocks_for(hi), len(table))):
            b = table[bi]
            if self.pool.refcount(b) > 1:
                dst = self._alloc(1)[0]
                self.pool.decref(b)
                table[bi] = dst
                pairs.append((b, dst))
        return pairs

    def ensure(self, slot: int, n_tokens: int) -> List[int]:
        """Grow ``slot``'s table to cover ``n_tokens``; returns new blocks."""
        need = self.blocks_for(n_tokens) - len(self._tables[slot])
        if need <= 0:
            return []
        if len(self._tables[slot]) + need > self.max_blocks:
            raise ValueError(
                f"slot {slot} would exceed the per-slot cap of "
                f"{self.max_blocks} blocks")
        new = self._alloc(need)
        self._tables[slot].extend(new)
        return new

    def commit(self, slot: int, n_new_tokens: int) -> None:
        self._tokens[slot] += int(n_new_tokens)

    def release(self, slot: int) -> List[int]:
        """Drop the slot's reference on every block (retire or preempt).

        Returns only the blocks that actually became free — blocks still
        referenced by the prefix cache (or another slot) survive with
        their KV rows intact, so the engine must clear device ``pos`` rows
        only for the returned ids.
        """
        blocks = self._tables[slot]
        self._tables[slot] = []
        self._tokens[slot] = 0
        self._pending.discard(slot)
        return self.pool.free(blocks)

    def device_tables(self, exclude_pending: bool = False) -> np.ndarray:
        """[capacity, max_blocks] int32 block table, -1 = unallocated.

        ``exclude_pending=True`` keeps mid-chunked-prefill slots' rows at -1:
        the decode step uploads with this set, so a parked slot's (masked,
        garbage) decode-step writes stay dropped on the device even while
        other slots' growth re-uploads the table — its blocks are only
        published by the final chunk's commit.
        """
        out = np.full((self.capacity, self.max_blocks), -1, np.int32)
        for i, t in enumerate(self._tables):
            if exclude_pending and i in self._pending:
                continue
            out[i, :len(t)] = t
        return out


class SlotPool:
    """Fixed-capacity slot bookkeeping: claim on admit, retire on finish."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._reqs: List[Optional[Request]] = [None] * capacity
        self._remaining = np.zeros(capacity, dtype=np.int64)
        # lowest-numbered free slot claimed first (deterministic placement)
        self._free = list(range(capacity - 1, -1, -1))

    # ------------------------------------------------------------------
    # lifecycle

    def claim(self, req: Request, slot: Optional[int] = None) -> int:
        """Assign ``req`` to a free slot; returns the slot index.

        Without ``slot``, the lowest-numbered free slot is claimed
        (deterministic placement).  With ``slot``, that specific free slot
        is claimed — the sharded scheduler's per-host admission queue
        (``HostShardQueue`` in the JAX package) uses this to
        round-robin placements across the data shards of a mesh-sharded
        pool.  A preempted request re-enters with ``n_generated > 0``; its
        budget resumes where it left off rather than restarting at
        ``max_new``.
        """
        if not self._free:
            raise RuntimeError("slot pool full")
        if slot is None:
            slot = self._free.pop()
        else:
            if slot not in self._free:
                raise RuntimeError(f"slot {slot} is not free")
            self._free.remove(slot)
        self._reqs[slot] = req
        self._remaining[slot] = req.max_new - req.n_generated
        return slot

    def is_free(self, slot: int) -> bool:
        return self._reqs[slot] is None

    def retire(self, slot: int) -> Request:
        """Release ``slot``; returns the request that occupied it."""
        req = self._reqs[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is not occupied")
        self._reqs[slot] = None
        self._remaining[slot] = 0
        self._free.append(slot)
        self._free.sort(reverse=True)
        return req

    # ------------------------------------------------------------------
    # accounting

    def consume(self, slot: int, tokens: int) -> None:
        self._remaining[slot] -= tokens

    def remaining(self, slot: int) -> int:
        return int(self._remaining[slot])

    def request_at(self, slot: int) -> Request:
        req = self._reqs[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is not occupied")
        return req

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._reqs) if r is not None]

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self._reqs)

    @property
    def free_count(self) -> int:
        return len(self._free)
