"""Radix-tree prefix index over the paged KV block pool (a copy of
``repro.serving.prefix_cache``, with its reclaimable count corrected).

Cross-request prefix sharing: admission looks up the longest cached prefix
of an incoming prompt (:meth:`PrefixCache.match` / :meth:`~PrefixCache.lock`),
maps those blocks into the new slot's table at refcount+1
(:meth:`~repro_torch.serving.slots.PagedKVTables.attach`) and prefills only
the uncached suffix; commit publishes the slot's own full prompt blocks back
into the index (:meth:`~PrefixCache.insert`), so templated traffic — many
requests sharing a system prompt or few-shot preamble — pays the shared
prefill exactly once.

The tree is a radix trie whose edges are *whole* KV blocks: every node
owns exactly one block and is keyed by the ``block_size``-tuple of tokens
that block holds.  Fixed-width keys mean lookup is a straight dictionary
walk with no edge splitting — a block either matches all of its tokens or
none of them, which is also the granularity at which block tables can
share physical storage.

Reference-count protocol: the cache holds its own +1 on every block it
indexes, taken at :meth:`insert` and dropped at eviction.  A block at
refcount 1 belongs to the cache alone.  :meth:`reclaim` evicts such blocks
LRU-first, leaves only (a node's children would be orphaned otherwise), so
a refcount-1 node is freed only once its whole subtree has gone.  That
subtree need not be free: after a copy-on-write swapped a shared block out
of a slot's table, the slot may still hold the block's child while the
parent is left to the cache alone.  :meth:`reclaimable` therefore counts
exactly the nodes whose whole subtree is at refcount 1 — what repeated
``reclaim`` can free — where the JAX package's copy counts every refcount-1
node and over-reports the pool's available blocks.  Blocks that are
matched but not yet attached are protected by :meth:`lock`, which takes a
temporary reference so a concurrent admission cannot reclaim them between
feasibility check and attach.

Determinism: recency is a monotone integer clock bumped once per mutating
operation, never wall time, so eviction order — and therefore every
downstream scheduling decision — replays identically sim vs live.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.slots import BlockPool


class _Node:
    """One trie node = one KV block = ``block_size`` prompt tokens."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Block-granular radix index of prompt prefixes held in the pool."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_size = pool.block_size
        self._root = _Node(None, -1, None)
        self._blocks: Dict[int, _Node] = {}
        self._clock = 0
        # cumulative counters for telemetry (the scheduler reads these)
        self.hits = 0
        self.hit_tokens = 0
        self.lookups = 0

    # ------------------------------------------------------------------
    # internals

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def _walk(self, tokens: Sequence[int]) -> List[_Node]:
        """Longest chain of nodes matching ``tokens`` block-by-block."""
        path: List[_Node] = []
        node = self._root
        for key in self._keys(tokens):
            child = node.children.get(key)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def _free_subtrees(self) -> set:
        """Block ids of the indexed nodes whose whole subtree is held by
        the cache alone (every node at refcount 1, none locked): exactly
        the blocks that repeated leaf-first :meth:`reclaim` can free."""
        order: List[_Node] = []            # pre-order: parents before children
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        free: set = set()
        for node in reversed(order):       # children before their parent
            if self.pool.refcount(node.block) == 1 and all(
                    c.block in free for c in node.children.values()):
                free.add(node.block)
        return free

    # ------------------------------------------------------------------
    # queries

    @property
    def size(self) -> int:
        """Number of blocks currently indexed."""
        return len(self._blocks)

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached prefix of ``tokens`` as block ids (pure read)."""
        return [n.block for n in self._walk(tokens)]

    def reclaimable_ids(self) -> List[int]:
        """Ids of the indexed blocks eviction could free right now: held
        by the cache alone, with no descendant held by anyone else."""
        free = self._free_subtrees()
        return [b for b in self._blocks if b in free]

    def reclaimable(self) -> int:
        """How many indexed blocks eviction could free right now."""
        return len(self._free_subtrees())

    # ------------------------------------------------------------------
    # admission protocol

    def lock(self, tokens: Sequence[int]) -> List[int]:
        """Match and pin: the returned prefix blocks each gain a temporary
        reference so reclaim cannot evict them between the admission
        feasibility check and
        :meth:`~repro_torch.serving.slots.PagedKVTables.attach`.
        The caller must drop the references with :meth:`unlock` (after
        attach takes the slot's own, or on admission abort)."""
        self.lookups += 1
        path = self._walk(tokens)
        now = self._tick()
        for n in path:
            n.last_used = now
            self.pool.incref(n.block)
        if path:
            self.hits += 1
            self.hit_tokens += len(path) * self.block_size
        return [n.block for n in path]

    def unlock(self, blocks: Sequence[int]) -> None:
        """Drop the temporary references taken by :meth:`lock`."""
        for b in blocks:
            self.pool.decref(b)

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Index ``tokens`` (full blocks only) backed by ``blocks``.

        ``blocks[i]`` is the slot-table block holding tokens
        ``[i*bs, (i+1)*bs)``.  Prefixes already indexed keep their existing
        node (and block id — the first writer wins; later duplicates stay
        exclusively owned by their slot); only genuinely new nodes take a
        cache reference.  Returns the number of new blocks indexed.
        """
        keys = self._keys(tokens)
        if len(blocks) < len(keys):
            raise ValueError(
                f"insert of {len(keys)} blocks of tokens backed by only "
                f"{len(blocks)} table blocks")
        now = self._tick()
        node = self._root
        added = 0
        for i, key in enumerate(keys):
            child = node.children.get(key)
            if child is None:
                b = int(blocks[i])
                if b in self._blocks:
                    raise RuntimeError(
                        f"block {b} already indexed elsewhere in the trie")
                self.pool.incref(b)
                child = _Node(key, b, node)
                node.children[key] = child
                self._blocks[b] = child
                added += 1
            child.last_used = now
            node = child
        return added

    # ------------------------------------------------------------------
    # eviction

    def reclaim(self, n: int) -> List[int]:
        """Evict up to ``n`` LRU cache-only blocks; returns evicted ids.

        Only leaves are evicted (children would be orphaned otherwise);
        evicting a leaf can expose its parent, so the scan repeats until
        ``n`` blocks freed or nothing is evictable.  Order is deterministic:
        oldest ``last_used`` first, lowest block id on ties.
        """
        evicted: List[int] = []
        while len(evicted) < n:
            best: Optional[_Node] = None
            for b, node in self._blocks.items():
                if node.children or self.pool.refcount(b) != 1:
                    continue
                if best is None or (node.last_used, node.block) < \
                        (best.last_used, best.block):
                    best = node
            if best is None:
                break
            del self._blocks[best.block]
            assert best.parent is not None
            del best.parent.children[best.key]
            self.pool.decref(best.block)
            evicted.append(best.block)
        return evicted
