"""The port's copy-on-write prefix cache on the CPU, against the JAX package.

* the unit and refcount tests of ``tests/test_prefix_cache.py`` on the
  port's ``BlockPool``, ``PagedKVTables`` and ``PrefixCache``;
* the same op sequences on JAX's classes and the port's give the same
  ``match``, ``lock``, ``insert`` and ``reclaim`` results and refcounts;
* the property campaign of ``tests/test_prefix_cache.py`` (roomy and under
  pressure), with one more check after every op: ``available_blocks``
  blocks can actually be allocated (on a deep copy).  The reference fails
  that check: its ``reclaimable()`` counts refcount-1 blocks whose child a
  slot still holds, which leaf-first ``reclaim`` cannot free.  Its failing
  example (``.hypothesis/patches/2026-10-16--0c80ac0e.patch``) is replayed:
  the port aborts the admission of op 29, the reference raises;
* the scheduler over the sim backend (signature, replay, eviction under
  pressure) and the live engine (ports of the live tests of
  ``tests/test_prefix_cache.py``, and the mixed launch with the cache):
  shared-prefix tokens equal the cold run's; one cache-on
  ``serve_continuous_live`` run on both engines;
* the engine: ``attach_prefix`` against JAX's, the zero-suffix
  ``commit_attached`` (with and without a copy-on-write copy) against a
  chunked admission of the same prompt, and the ``pos`` wipe of evicted
  blocks after each of the six host allocations of the engine.

Tolerances: fp32 K/V rows 1e-5 (absolute plus relative); positions, block
tables, refcounts, counts, row state and tokens exact.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # fallback shim, see tests/_hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, st

from repro.configs import registry as JR
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import SpeculationLUT as JLUT
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.serving import prefix_cache as jprefix
from repro.serving import scheduler as jsched
from repro.serving import slots as jslots
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core.adaptive import (AdaptiveController, SpeculationLUT,
                                       fixed_controller)
from repro_torch.core.analytical import LatencyModel
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.serving import PrefixCache
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend,
                                           ContinuousScheduler, ImmediateAdmit,
                                           PrefillBudgetAdmit, SimStepBackend,
                                           replay_sources,
                                           serve_continuous_live)
from repro_torch.serving.slots import BlockPool, PagedKVTables
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

BS = 4                                   # block size of the host tests
TOL = dict(rtol=1e-5, atol=1e-5)


def _kv(num_blocks=24, capacity=4, max_blocks=8, cache=True, pkg="port"):
    tables, cache_cls = ((PagedKVTables, PrefixCache) if pkg == "port"
                         else (jslots.PagedKVTables, jprefix.PrefixCache))
    kv = tables(num_blocks, BS, capacity, max_blocks)
    pc = None
    if cache:
        pc = cache_cls(kv.pool)
        kv.attach_cache(pc)
    return kv, pc


# ---------------------------------------------------------------------------
# refcount lifecycle (BlockPool)


def test_refcount_lifecycle():
    pool = BlockPool(6, BS)
    a, b = pool.alloc(2)
    assert pool.refcount(a) == pool.refcount(b) == 1
    pool.incref(a)
    assert pool.refcount(a) == 2 and pool.shared_count == 1
    assert pool.exclusive_count == 1
    assert pool.decref(a) is False       # still held once
    assert pool.decref(a) is True        # now actually freed
    assert pool.refcount(a) == 0 and a in pool._free
    pool.check_invariants()


@pytest.mark.parametrize("op", ["decref", "free", "incref"])
def test_double_free_raises(op):
    """decref, a bulk free and an incref of a free block are all bugs."""
    pool = BlockPool(4, BS)
    (a,) = pool.alloc(1)
    pool.decref(a)
    with pytest.raises(RuntimeError):
        pool.free([a]) if op == "free" else getattr(pool, op)(a)


def test_bulk_free_returns_only_actually_freed():
    pool = BlockPool(6, BS)
    a, b, c = pool.alloc(3)
    pool.incref(b)                       # b shared with a second owner
    assert pool.free([a, b, c]) == [a, c]  # b survives at refcount 1
    assert pool.refcount(b) == 1
    assert pool.free([b]) == [b]
    pool.check_invariants()
    assert pool.free_count == 6


# ---------------------------------------------------------------------------
# radix index (PrefixCache)


def test_radix_insert_match_roundtrip():
    kv, pc = _kv()
    kv.prefill(0, 3 * BS)
    tokens = np.arange(3 * BS, dtype=np.int32)
    assert pc.insert(tokens, kv.table(0)) == 3 and pc.size == 3
    assert pc.match(tokens) == kv.table(0)[:3]
    # partial-block tails never match (block granularity)
    assert pc.match(tokens[:2 * BS + 1]) == kv.table(0)[:2]
    # diverging tokens stop the walk at the shared prefix
    div = tokens.copy()
    div[2 * BS] += 1
    assert pc.match(div) == kv.table(0)[:2]
    assert pc.match(np.arange(100, 100 + BS, dtype=np.int32)) == []


def test_radix_first_writer_wins_and_rejects_double_index():
    kv, pc = _kv()
    tokens = np.arange(2 * BS, dtype=np.int32)
    kv.prefill(0, 2 * BS)
    kv.prefill(1, 2 * BS)
    pc.insert(tokens, kv.table(0))
    # same prefix from another slot: existing nodes keep the first blocks
    assert pc.insert(tokens, kv.table(1)) == 0
    assert pc.match(tokens) == kv.table(0)[:2]
    # a block id cannot back two different trie nodes
    with pytest.raises(RuntimeError):
        pc.insert(np.arange(50, 50 + BS, dtype=np.int32), [kv.table(0)[0]])
    with pytest.raises(ValueError):
        pc.insert(tokens, kv.table(0)[:1])   # fewer blocks than token blocks


def test_lock_pins_against_reclaim():
    kv, pc = _kv()
    t_a = np.arange(0, 2 * BS, dtype=np.int32)
    t_b = np.arange(100, 100 + BS, dtype=np.int32)
    kv.prefill(0, 2 * BS)
    kv.prefill(1, BS)
    pc.insert(t_a, kv.table(0))
    pc.insert(t_b, kv.table(1))
    b_unlocked = kv.table(1)[0]
    kv.release(0), kv.release(1)         # cache is now the only owner
    assert pc.reclaimable() == 3
    locked = pc.lock(t_a)
    assert len(locked) == 2 and pc.reclaimable() == 1
    # locked blocks are not evictable — only t_b's block goes
    evicted = pc.reclaim(10)
    assert evicted == [b_unlocked]
    assert set(evicted).isdisjoint(locked)
    assert pc.size == 2
    pc.unlock(locked)
    assert pc.reclaim(10) != [] and pc.size == 0
    kv.pool.check_invariants()
    assert kv.pool.free_count == kv.num_blocks


def test_reclaim_is_lru_and_leaf_first():
    kv, pc = _kv()
    kv.prefill(0, 3 * BS)
    pc.insert(np.arange(0, 3 * BS, dtype=np.int32), kv.table(0))   # chain of 3
    blocks = list(kv.table(0))
    kv.release(0)
    # the deepest node is the only leaf: eviction drains leaf-first even
    # though the root of the chain is older
    assert [pc.reclaim(1) for _ in range(3)] == [[blocks[2]], [blocks[1]], [blocks[0]]]
    # LRU across independent entries: older last_used goes first
    kv.prefill(0, BS)
    pc.insert(np.arange(100, 100 + BS, dtype=np.int32), kv.table(0))
    old = kv.table(0)[0]
    kv.release(0)
    kv.prefill(1, BS)
    pc.insert(np.arange(200, 200 + BS, dtype=np.int32), kv.table(1))
    new = kv.table(1)[0]
    kv.release(1)
    assert pc.reclaim(1) == [old]
    assert pc.reclaim(1) == [new]


def test_reclaimable_counts_only_what_reclaim_can_free():
    """The reference's fault: after a copy-on-write swapped a shared parent
    out of a slot's table, the parent is at refcount 1 (the cache's) while
    the slot still holds its child.  Leaf-first reclaim cannot free the
    parent, so it is not reclaimable, nor available to an allocation."""
    for pkg, parent_counted in (("port", False), ("jax", True)):
        kv, pc = _kv(num_blocks=4, capacity=2, max_blocks=4, pkg=pkg)
        kv.prefill(0, 2 * BS + 1)
        tokens = np.arange(2 * BS, dtype=np.int32)
        pc.insert(tokens, kv.table(0))
        parent, child = kv.table(0)[:2]
        kv.release(0)                    # cache-only chain parent -> child
        locked = pc.lock(tokens)
        kv.attach(1, locked, 2 * BS)
        pc.unlock(locked)
        assert kv.cow_for_range(1, 0, BS)[0][0] == parent   # slot 1 keeps the child
        assert kv.pool.refcount(parent) == 1 and kv.pool.refcount(child) == 2
        assert (parent in pc.reclaimable_ids()) == parent_counted, pkg
        assert pc.reclaimable() == int(parent_counted), pkg
        assert pc.reclaim(1) == []       # nothing is evictable, in either package
        kv2 = copy.deepcopy(kv)
        if parent_counted:
            with pytest.raises(jslots.BlockPoolExhausted):
                kv2._alloc(kv2.available_blocks)
        else:
            kv2._alloc(kv2.available_blocks)
            kv2.pool.check_invariants()
        # once the slot lets go of the child, the whole chain is reclaimable
        kv.release(1)
        assert pc.reclaimable() == 2 and sorted(pc.reclaim(5)) == sorted([parent, child])


# ---------------------------------------------------------------------------
# attach / COW over the slot tables


def test_attach_shares_blocks_and_cow_isolates_writes():
    kv, pc = _kv()
    tokens = np.arange(2 * BS, dtype=np.int32)
    kv.prefill(0, 2 * BS + 2)            # donor: 2 full blocks + a tail
    pc.insert(tokens, kv.table(0))
    locked = pc.lock(tokens)
    kv.attach(1, locked, 2 * BS)
    pc.unlock(locked)
    assert kv.table(1) == kv.table(0)[:2]
    assert all(kv.pool.refcount(b) == 3 for b in locked)  # donor+cache+slot1
    assert kv.shared_blocks == 2
    # slot 1 writes into the shared range: COW swaps in fresh copies
    pairs = kv.cow_for_range(1, 0, 2 * BS)
    assert [src for src, _ in pairs] == locked
    assert kv.table(1) != kv.table(0)[:2]
    assert all(kv.pool.refcount(dst) == 1 for _, dst in pairs)
    assert all(kv.pool.refcount(src) == 2 for src, _ in pairs)
    # donor's own table is untouched and still cache-indexed
    assert pc.match(tokens) == kv.table(0)[:2]
    kv.release(0), kv.release(1)
    kv.pool.check_invariants()


@pytest.mark.parametrize("slot,n_tokens,err", [(1, BS, RuntimeError),      # non-empty slot
                                               (2, BS + 1, ValueError)],   # not block-aligned
                         ids=["occupied_slot", "unaligned"])
def test_attach_rejects_bad_geometry(slot, n_tokens, err):
    kv, pc = _kv()
    kv.prefill(0, BS)
    pc.insert(np.arange(BS, dtype=np.int32), kv.table(0))
    locked = pc.lock(np.arange(BS, dtype=np.int32))
    kv.prefill(1, 2)
    with pytest.raises(err):
        kv.attach(slot, locked, n_tokens)
    pc.unlock(locked)


def test_alloc_reclaims_cache_blocks_on_demand():
    kv, pc = _kv(num_blocks=4, capacity=2, max_blocks=4)
    kv.prefill(0, 3 * BS)
    pc.insert(np.arange(3 * BS, dtype=np.int32), kv.table(0))
    kv.release(0)                        # 3 blocks cache-only, 1 free
    assert kv.free_blocks == 1 and kv.available_blocks == 4
    kv.prefill(1, 3 * BS)                # needs 3: evicts 2 from the cache
    assert kv.evicted_pending and kv.evicted_total == 2
    assert pc.size == 1
    kv.pool.check_invariants()


# ---------------------------------------------------------------------------
# sharing-aware fragmentation / occupancy accounting


def test_fragmentation_counts_reclaimable_blocks():
    kv, pc = _kv(num_blocks=8, capacity=4, max_blocks=4)
    kv.prefill(0, BS)                    # block 0
    kv.prefill(1, BS)                    # block 1
    kv.prefill(2, BS)                    # block 2
    pc.insert(np.arange(100, 100 + BS, dtype=np.int32), kv.table(1))
    kv.release(1)                        # block 1: cache-only (reclaimable)
    # free ∪ reclaimable = {1, 3, 4, 5, 6, 7}: largest run 5 of 6
    assert kv.available_blocks == 6
    assert kv.fragmentation == pytest.approx(1 - 5 / 6)
    # a cache-held block that is also slot-shared is NOT reclaimable
    locked = pc.lock(np.arange(100, 100 + BS, dtype=np.int32))
    assert kv.available_blocks == 5
    assert kv.fragmentation == pytest.approx(0.0)
    pc.unlock(locked)


def test_shared_vs_exclusive_gauges():
    kv, pc = _kv()
    kv.prefill(0, 2 * BS)
    tokens = np.arange(2 * BS, dtype=np.int32)
    pc.insert(tokens, kv.table(0))
    assert kv.shared_blocks == 2         # slot 0 + cache
    assert kv.cached_blocks == 2
    locked = pc.lock(tokens)
    kv.attach(1, locked, 2 * BS)
    pc.unlock(locked)
    assert kv.shared_blocks == 2 and kv.pool.exclusive_count == 0
    kv.release(0), kv.release(1)
    assert kv.shared_blocks == 0 and kv.cached_blocks == 2
    assert kv.pool.exclusive_count == 2  # cache is now the only owner


# ---------------------------------------------------------------------------
# the property campaign: random interleavings against a shadow model


class _Machine:
    """Drives PagedKVTables + PrefixCache (the port's, or with ``pkg="jax"``
    the reference's) with the randomized operations of the JAX package's
    campaign and checks the standing invariants after each one.

    Shadow model: the expected refcount of every block is (number of slot
    tables containing it) + (1 if the cache indexes it); blocks with
    expected refcount 0 are exactly the free list.  ``check`` adds the
    available-blocks check: ``available_blocks`` blocks can be allocated
    (on a deep copy, so the campaign itself is not disturbed)."""

    PREFIXES = 3                          # shared system-prompt vocabulary

    def __init__(self, num_blocks=16, capacity=4, max_blocks=6, pkg="port"):
        self.kv, self.pc = _kv(num_blocks, capacity, max_blocks, pkg=pkg)
        self.capacity = capacity
        self.slots = {}                   # slot -> [tokens, tainted]
        self.log = []                     # what each op returned

    def _prompt(self, seed):
        rng = np.random.default_rng(seed)
        pfx = int(rng.integers(self.PREFIXES))
        n_pre = int(rng.integers(1, 3))          # 1-2 shared blocks
        tail = rng.integers(0, 5)
        sys = np.arange(1000 * pfx, 1000 * pfx + n_pre * BS, dtype=np.int32)
        tl = rng.integers(0, 30, (int(tail),)).astype(np.int32) + 5000
        return np.concatenate([sys, tl])

    def admit(self, seed):
        free = [s for s in range(self.capacity) if s not in self.slots]
        if not free:
            return None
        slot = free[0]
        prompt = self._prompt(seed)
        total = len(prompt) + 1                  # +1: the first decode row
        locked = self.pc.lock(prompt)
        P = len(locked) * BS
        need = self.kv.blocks_for(total) - P // BS + (1 if P == total else 0)
        if need > self.kv.available_blocks:
            self.pc.unlock(locked)               # admission abort
            return ("abort", locked)
        if P:
            self.kv.attach(slot, locked, P)
            self.pc.unlock(locked)
            self.kv.ensure(slot, total)
            self.kv.commit(slot, total - P)
        else:
            self.pc.unlock(locked)
            self.kv.prefill(slot, total)
        self.kv.evicted_pending.clear()
        self.slots[slot] = [prompt, False]
        return ("admit", slot, locked, self.kv.table(slot))

    def write(self, seed):
        """COW-write a random row range of a random slot: afterwards every
        block covering the range is exclusively owned."""
        if not self.slots:
            return None
        rng = np.random.default_rng(seed)
        slot = list(self.slots)[int(rng.integers(len(self.slots)))]
        n = self.kv.tokens(slot)
        lo = int(rng.integers(n))
        hi = int(rng.integers(lo, n)) + 1
        covered = self.kv.table(slot)[lo // BS:self.kv.blocks_for(hi)]
        if sum(self.kv.pool.refcount(b) > 1 for b in covered) > self.kv.available_blocks:
            return None                          # a scheduler preempts first
        pairs = self.kv.cow_for_range(slot, lo, hi)
        self.kv.evicted_pending.clear()
        for bi in range(lo // BS, self.kv.blocks_for(hi)):
            b = self.kv.table(slot)[bi]
            others = sum(b in self.kv.table(s) for s in self.slots if s != slot)
            assert self.kv.pool.refcount(b) == 1 and others == 0 \
                and b not in self.pc._blocks, f"post-COW block {b} still shared"
        assert all(self.kv.pool.refcount(src) >= 1 for src, _ in pairs)
        if lo // BS < len(self.slots[slot][0]) // BS:
            self.slots[slot][1] = True           # prompt blocks no longer hold the prompt
        return ("write", slot, pairs)

    def insert(self, seed):
        if not self.slots:
            return None
        rng = np.random.default_rng(seed)
        slot = list(self.slots)[int(rng.integers(len(self.slots)))]
        prompt, tainted = self.slots[slot]
        n_ins = len(prompt) // BS
        if tainted or not n_ins:
            return None
        added = self.pc.insert(prompt[:n_ins * BS], self.kv.table(slot)[:n_ins])
        assert len(self.pc.match(prompt[:n_ins * BS])) == n_ins   # round-trip
        return ("insert", slot, added)

    def retire(self, seed):
        if not self.slots:
            return None
        rng = np.random.default_rng(seed)
        slot = list(self.slots)[int(rng.integers(len(self.slots)))]
        freed = self.kv.release(slot)
        assert all(self.kv.pool.refcount(b) == 0 for b in freed)
        del self.slots[slot]
        return ("retire", slot, freed)

    def evict(self, seed):
        rng = np.random.default_rng(seed)
        before = self.pc.size
        evicted = self.pc.reclaim(int(rng.integers(1, 4)))
        assert self.pc.size == before - len(evicted)
        assert all(self.kv.pool.refcount(b) == 0 and b not in self.pc._blocks
                   for b in evicted)
        return ("evict", evicted)

    def lock_cycle(self, seed):
        """Lock a prefix, apply reclaim pressure, check the locked blocks
        survive, then release the lock (eviction races admission)."""
        locked = self.pc.lock(self._prompt(seed))
        evicted = self.pc.reclaim(2)
        assert set(evicted).isdisjoint(locked)
        assert all(self.kv.pool.refcount(b) >= 1 for b in locked)
        self.pc.unlock(locked)
        return ("lock_cycle", locked, evicted)

    OPS = (admit, write, insert, retire, evict, lock_cycle)

    def step(self, code, seed):
        out = _Machine.OPS[code](self, seed)
        self.log.append((out, list(self.kv.pool._refs)))
        return out

    def check(self):
        pool = self.kv.pool
        pool.check_invariants()                  # partition + free-list shape
        expected = [0] * self.kv.num_blocks
        for slot in self.slots:
            for b in self.kv.table(slot):
                expected[b] += 1
        for b in self.pc._blocks:
            expected[b] += 1
        assert [pool.refcount(b) for b in range(self.kv.num_blocks)] == expected, \
            "refcounts differ from the shadow model (leak or double count)"
        assert set(pool._free) == {b for b, e in enumerate(expected) if e == 0}
        # what available_blocks reports can be allocated
        kv = copy.deepcopy(self.kv)
        n = kv.available_blocks
        kv._alloc(n)
        assert kv.free_blocks == 0 and kv.available_blocks == 0
        kv.pool.check_invariants()


OPS_STRATEGY = st.lists(st.tuples(st.integers(0, len(_Machine.OPS) - 1),
                                  st.integers(0, 10**6)), min_size=1, max_size=40)


@settings(max_examples=500, deadline=None)
@given(OPS_STRATEGY)
def test_property_interleavings(ops):
    """500 random admit/share/COW-write/insert/retire/evict interleavings
    keep every refcount invariant, and available blocks can be allocated."""
    m = _Machine()
    for code, seed in ops:
        m.step(code, seed)
        m.check()


@settings(max_examples=24, deadline=None)
@given(st.lists(st.tuples(st.integers(0, len(_Machine.OPS) - 1),
                          st.integers(0, 10**6)),
                min_size=30, max_size=120),
       st.booleans())
def test_property_interleavings_under_pressure(ops, tiny):
    """The same campaign on an undersized pool: allocation-triggered
    eviction races admission and the invariants still hold."""
    m = _Machine(num_blocks=6 if tiny else 9, capacity=3, max_blocks=5)
    for code, seed in ops:
        m.step(code, seed)
        m.check()


# the reference's failing example (.hypothesis/patches/2026-10-16--0c80ac0e.patch)
REF_FAILURE = ([(0, 0)] * 20 + [(3, 0)] * 3
               + [(0, 63), (2, 0), (0, 0), (0, 0), (0, 0), (1, 85742), (0, 116)])


def test_reference_failure_example_passes_on_the_port():
    m = _Machine(num_blocks=9, capacity=3, max_blocks=5)
    for i, (code, seed) in enumerate(REF_FAILURE):
        before = dict(m.slots)
        out = m.step(code, seed)
        m.check()
        if i == 29:
            # the cache block it would count can never be freed: abort
            assert out[0] == "abort" and m.slots == before
    # the reference over-reports available blocks there and raises
    j = _Machine(num_blocks=9, capacity=3, max_blocks=5, pkg="jax")
    for code, seed in REF_FAILURE[:29]:
        j.step(code, seed)
    with pytest.raises(jslots.BlockPoolExhausted, match="requested 2 blocks, only 1 free"):
        j.step(*REF_FAILURE[29])


@pytest.mark.parametrize("seed", range(4))
def test_op_sequences_match_jax(seed):
    """A roomy pool (no admission ever hits the limit, where the two
    packages' available counts may differ): every op returns the same
    match, lock, insert and reclaim results, and the refcounts agree."""
    rng = np.random.default_rng(seed)
    ms = [_Machine(num_blocks=64, capacity=4, max_blocks=6, pkg=p) for p in ("port", "jax")]
    for _ in range(150):
        code, s = int(rng.integers(len(_Machine.OPS))), int(rng.integers(10**6))
        outs = [m.step(code, s) for m in ms]
        assert outs[0] == outs[1], (code, s)
        assert ms[0].log[-1][1] == ms[1].log[-1][1]
        matches = [m.pc.match(m._prompt(s + 1)) for m in ms]
        assert matches[0] == matches[1]
        ms[0].check()


# ---------------------------------------------------------------------------
# the scheduler over the sim backend


def _model(batches=(1, 2, 4, 8, 16, 32)):
    return LatencyModel(alpha={b: 1e-4 * b ** 0.8 for b in batches},
                        beta={b: 5e-3 for b in batches},
                        t_s={b: 2e-4 for b in batches}, c=0.9, gamma=0.548)


def _sim_reqs(n, sys_len=16, tail=5, max_new=8):
    sys = np.arange(100, 100 + sys_len, dtype=np.int32)
    return [Request(rid=i, arrival=0.0,
                    tokens=np.concatenate([sys, np.arange(1000 * i, 1000 * i + tail,
                                                          dtype=np.int32)]),
                    prompt_len=sys_len + tail, max_new=max_new) for i in range(n)]


def _sig(trace):
    return [(t.occupancy, t.s, t.rids, tuple(sorted(t.committed.items())),
             t.admitted, t.preempted, t.done_rids) for t in trace]


def test_sim_shared_vs_cold_scheduling_signature():
    """With ImmediateAdmit and a roomy pool the cache changes when work
    happens inside an iteration, never what the scheduler decides."""
    def run(cache):
        be = SimStepBackend(_model(), capacity=4, seed=3, block_size=8, num_blocks=40,
                            max_context=64, prefix_cache=cache, prefill_token_cost=1e-3)
        sched = ContinuousScheduler(be, fixed_controller(4), policy=ImmediateAdmit())
        return be, sched, sched.run(_sim_reqs(4))

    be_c, sc_c, res_c = run(True)
    _, sc_0, res_0 = run(False)
    assert _sig(sc_c.trace) == _sig(sc_0.trace)
    hits = [h for t in sc_c.trace for h in t.cache_hits]
    assert hits and all(p == 16 for _, p in hits)
    assert all(not t.cache_hits for t in sc_0.trace)
    be_c.kv.pool.check_invariants()
    # cached prefills fed fewer rows: strictly earlier first tokens
    assert (sum(r.first_token for r in res_c.requests)
            < sum(r.first_token for r in res_0.requests))


def test_sim_replay_with_cache_hits():
    """replay_sources over a cache-on trace reproduces it exactly, the
    cache_hits column included (chunked admission path)."""
    def build(**src):
        return SimStepBackend(_model(), capacity=4, seed=3, block_size=8, num_blocks=40,
                              max_context=96, prefix_cache=True, **src)

    def run(be):
        sched = ContinuousScheduler(be, fixed_controller(4),
                                    policy=PrefillBudgetAdmit(token_budget=16, chunk=8))
        sched.run(_sim_reqs(3, sys_len=16, tail=20))
        return sched

    sched = run(build(prefill_token_cost=1e-3))
    assert any(t.cache_hits for t in sched.trace) and any(t.chunked for t in sched.trace)
    accept, duration, prefill, done, chunk = replay_sources(sched.trace)
    sched2 = run(build(accept_source=accept, duration_source=duration,
                       prefill_source=prefill, done_source=done, chunk_source=chunk))
    assert sched2.trace == sched.trace


def test_sim_eviction_under_pressure_completes():
    """An undersized pool: cache blocks are evicted to make room,
    admissions never map evicted blocks, every request completes, and the
    pool accounting holds."""
    be = SimStepBackend(_model(), capacity=3, seed=3, block_size=4, num_blocks=12,
                        max_context=48, prefix_cache=True, prefill_token_cost=1e-3)
    sched = ContinuousScheduler(be, fixed_controller(2))
    res = sched.run(_sim_reqs(10, sys_len=8, tail=8, max_new=6))
    assert all(r.n_generated == r.max_new for r in res.requests)
    assert be.kv.evicted_total > 0 and be.cache.hits > 0
    assert any(t.preempted for t in sched.trace)
    be.kv.pool.check_invariants()
    assert be.kv.active_slots() == []
    assert be.kv.free_blocks + be.kv.cached_blocks == be.kv.num_blocks


def test_sim_backend_needs_a_paged_mirror():
    with pytest.raises(ValueError, match="paged"):
        SimStepBackend(_model(), capacity=2, prefix_cache=True)


# ---------------------------------------------------------------------------
# the live engine (yi-9b smoke pair, 1-layer draft, block size 8)

CACHE_LEN = 96
BLOCK = 8


def _draft(registry, tcfg):
    d = registry.get_draft_config("yi-9b")
    return dataclasses.replace(
        d, n_layers=1, d_model=64, d_ff=128, vocab_size=tcfg.vocab_size,
        attn=dataclasses.replace(d.attn, n_heads=2, n_kv_heads=2, head_dim=32))


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port engine on the same JAX-initialised weights."""
    jcfg, tcfg = JR.get_smoke_config("yi-9b"), R.get_smoke_config("yi-9b")
    je = JEngine(jcfg, _draft(JR, jcfg), max_new=24)
    te = SpecDecodeEngine(tcfg, _draft(R, tcfg), max_new=24, device="cpu")
    jt = jax.tree.map(np.asarray, je.target.init(jax.random.PRNGKey(0)))
    jd = jax.tree.map(np.asarray, je.draft.init(jax.random.PRNGKey(1)))
    return je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"), tcfg


@pytest.fixture(scope="module")
def engine(pair):
    _, _, _, te, tt, td, tcfg = pair
    return te, tt, td, tcfg


def _ctrl(cls=AdaptiveController, lut=SpeculationLUT):
    return cls(lut=lut({1: 4, 2: 3, 4: 2}))


def _live_reqs(vocab, n=4, sys_len=16, tail=5, max_new=8, seed=5, cls=Request):
    rng = np.random.default_rng(seed)
    sys = rng.integers(0, vocab, (sys_len,)).astype(np.int32)
    return [cls(rid=i, arrival=0.0,
                tokens=np.concatenate([sys, rng.integers(0, vocab, (tail,)).astype(np.int32)]),
                prompt_len=sys_len + tail, max_new=max_new) for i in range(n)]


def _run_live(engine, reqs, *, prefix_cache, policy=None, num_blocks=48, capacity=4,
              mixed_launch=False):
    eng, tp, dp, _ = engine
    be = ContinuousEngineBackend(eng, tp, dp, capacity=capacity, cache_len=CACHE_LEN,
                                 warm_s=[2, 3, 4], block_size=BLOCK, num_blocks=num_blocks,
                                 collect_outputs=True, s_cap=4, prefix_cache=prefix_cache,
                                 mixed_launch=mixed_launch)
    sched = ContinuousScheduler(be, _ctrl(), policy=policy)
    sched.run(reqs)
    return be, sched


def test_live_shared_vs_cold_identity(engine):
    """Shared-prefix serving gives the cold run's tokens and scheduling
    signature; three of four requests hit the 16-token prefix."""
    reqs = lambda: _live_reqs(engine[3].vocab_size)
    be_c, sc_c = _run_live(engine, reqs(), prefix_cache=True)
    be_0, sc_0 = _run_live(engine, reqs(), prefix_cache=False)
    hits = [h for t in sc_c.trace for h in t.cache_hits]
    assert len(hits) == 3 and all(p == 16 for _, p in hits)
    for rid in range(4):
        np.testing.assert_array_equal(be_c.outputs[rid], be_0.outputs[rid], err_msg=f"rid {rid}")
        assert len(be_c.outputs[rid]) == 8
    assert _sig(sc_c.trace) == _sig(sc_0.trace)
    be_c.kv.pool.check_invariants()


@pytest.mark.parametrize("mixed", [False, True], ids=["chunked", "mixed_launch"])
def test_live_chunked_partial_hit(engine, mixed):
    """Chunked admission of a partially cached prompt: the cached prefix is
    attached, only the uncached suffix goes through the chunk path (with
    ``mixed_launch``, riding the steps), and the tokens equal the cold
    run's."""
    eng = engine[0]
    reqs = lambda: _live_reqs(engine[3].vocab_size, n=3, sys_len=16, tail=20, max_new=6,
                              seed=9)
    pol = lambda: PrefillBudgetAdmit(token_budget=16, chunk=8)
    fused = []
    step_with_chunk = eng.step_with_chunk
    eng.step_with_chunk = lambda *a, **kw: fused.append(1) or step_with_chunk(*a, **kw)
    try:
        be_c, sc_c = _run_live(engine, reqs(), prefix_cache=True, policy=pol(),
                               mixed_launch=mixed)
    finally:
        del eng.step_with_chunk
    be_0, sc_0 = _run_live(engine, reqs(), prefix_cache=False, policy=pol())
    hits = [h for t in sc_c.trace for h in t.cache_hits]
    assert hits, "no cache hit on the shared prefix"
    hit_rids = {rid for rid, _ in hits}
    # a hit feeds its suffix as chunks from the prefix on
    assert any(rid in hit_rids for t in sc_c.trace for rid, _ in t.chunked)
    assert bool(fused) == mixed
    for rid in range(3):
        np.testing.assert_array_equal(be_c.outputs[rid], be_0.outputs[rid], err_msg=f"rid {rid}")
    be_c.kv.pool.check_invariants()


def test_live_preempt_then_restore_shared_prefix(engine):
    """An undersized pool forces preemption; a victim's re-admission
    re-attaches the surviving shared prefix, and the tokens equal the roomy
    cold run's."""
    mk = lambda: _live_reqs(engine[3].vocab_size, n=4, sys_len=16, tail=3, max_new=16,
                            seed=11)
    be_c, sc_c = _run_live(engine, mk(), prefix_cache=True, num_blocks=12)
    preempted = [r for t in sc_c.trace for r in t.preempted]
    assert preempted, "pool was not small enough to force preemption"
    hit_rids = {rid for t in sc_c.trace for rid, _ in t.cache_hits}
    assert hit_rids & set(preempted), "no preempted request re-admitted via the prefix"
    be_0, _ = _run_live(engine, mk(), prefix_cache=False, num_blocks=48)
    for rid in range(4):
        np.testing.assert_array_equal(be_c.outputs[rid], be_0.outputs[rid], err_msg=f"rid {rid}")
    be_c.kv.pool.check_invariants()


def test_sim_vs_live_replay_with_cache(engine):
    """A cache-on live trace replays exactly on a cache-on sim backend with
    the live pool's geometry, the cache_hits column included."""
    reqs = lambda: _live_reqs(engine[3].vocab_size)
    _, sc = _run_live(engine, reqs(), prefix_cache=True)
    accept, duration, prefill, done, chunk = replay_sources(sc.trace)
    sim = SimStepBackend(_model(), capacity=4, seed=0, block_size=BLOCK, num_blocks=48,
                         max_context=CACHE_LEN, prefix_cache=True, accept_source=accept,
                         duration_source=duration, prefill_source=prefill,
                         done_source=done, chunk_source=chunk)
    sched = ContinuousScheduler(sim, _ctrl())
    sched.run(reqs())
    assert sched.trace == sc.trace


def _pressure_reqs(vocab, cls=Request):
    """Twelve requests on two system prompts (24 and 16 tokens) with 3-30
    token tails, and two prompts that are exactly a system prompt (the
    zero-suffix, copy-on-write admission)."""
    rng = np.random.default_rng(13)
    systems = [rng.integers(0, vocab, n).astype(np.int32) for n in (24, 16)]
    out = []
    for i in range(12):
        sys = systems[i % 2]
        tail = (np.zeros(0, np.int32) if i in (6, 9) else
                rng.integers(0, vocab, int(rng.integers(3, 31))).astype(np.int32))
        toks = np.concatenate([sys, tail])
        out.append(cls(rid=i, arrival=0.0, tokens=toks, prompt_len=len(toks),
                       max_new=int(rng.integers(6, 17))))
    return out


def test_cache_serving_matches_jax(pair):
    """A paged, undersized pool with the cache and chunked admission: the
    two packages' serve_continuous_live give equal admitted, chunked,
    committed, preempted and cache_hits columns and equal tokens."""
    je, jt, jd, te, tt, td, tcfg = pair
    geo = dict(capacity=4, cache_len=CACHE_LEN, block_size=BLOCK, num_blocks=12,
               collect_outputs=True, warm_s=(2, 3, 4), prefix_cache=True)
    runs = []
    for eng, tp, dp, cls, backend_cls, serve, policy, ctrl in (
            (je, jt, jd, JRequest, jsched.ContinuousEngineBackend,
             jsched.serve_continuous_live, jsched.PrefillBudgetAdmit, _ctrl(JController, JLUT)),
            (te, tt, td, Request, ContinuousEngineBackend, serve_continuous_live,
             PrefillBudgetAdmit, _ctrl())):
        backend = backend_cls(eng, tp, dp, **geo)
        res = serve(_pressure_reqs(tcfg.vocab_size, cls), eng, tp, dp, ctrl,
                    backend=backend, policy=policy(token_budget=16, chunk=8))
        runs.append((res, backend))
    (jres, jbe), (tres, tbe) = runs
    hits = [h for t in tres.trace for h in t.cache_hits]
    assert len(hits) >= 6 and any(t.chunked for t in tres.trace)
    assert any(t.preempted for t in tres.trace)
    # a zero-suffix admission (prompt = a whole system prompt), copy-on-write
    assert any(p == len(tres.requests[rid].tokens) for rid, p in hits)
    for field in ("admitted", "chunked", "committed", "preempted", "cache_hits"):
        assert ([getattr(t, field) for t in tres.trace]
                == [getattr(t, field) for t in jres.trace]), field
    for r in tres.requests:
        assert r.n_generated == r.max_new
        np.testing.assert_array_equal(tbe.outputs[r.rid], np.asarray(jbe.outputs[r.rid]),
                                      err_msg=f"rid {r.rid}")
    tbe.kv.pool.check_invariants()


def test_reference_fault_in_a_serving_run(pair):
    """The same trace on 14 blocks: the reference's over-counted
    reclaimable blocks let an admission through that its allocation then
    cannot serve, and its serve_continuous_live raises; the port's run
    completes, with the cold run's tokens."""
    je, jt, jd, te, tt, td, tcfg = pair
    geo = dict(capacity=4, cache_len=CACHE_LEN, block_size=BLOCK, num_blocks=14,
               collect_outputs=True, warm_s=(2, 3, 4))
    jbe = jsched.ContinuousEngineBackend(je, jt, jd, prefix_cache=True, **geo)
    with pytest.raises(jslots.BlockPoolExhausted):
        jsched.serve_continuous_live(_pressure_reqs(tcfg.vocab_size, JRequest), je, jt, jd,
                                     _ctrl(JController, JLUT), backend=jbe,
                                     policy=jsched.PrefillBudgetAdmit(token_budget=16, chunk=8))
    outs = []
    for cache in (True, False):
        be = ContinuousEngineBackend(te, tt, td, prefix_cache=cache, **geo)
        res = serve_continuous_live(_pressure_reqs(tcfg.vocab_size), te, tt, td, _ctrl(),
                                    backend=be,
                                    policy=PrefillBudgetAdmit(token_budget=16, chunk=8))
        assert all(r.n_generated == r.max_new for r in res.requests)
        outs.append(be.outputs)
    assert any(t.preempted for t in res.trace)
    for rid in outs[1]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid], err_msg=f"rid {rid}")


# ---------------------------------------------------------------------------
# the engine: attach_prefix, commit_attached, the wipe of evicted blocks


def test_attach_prefix_matches_jax(pair):
    """attach_prefix over a slot whose previous occupant left draft rows:
    the draft pool and seq_lens equal JAX's (the draft row replaced
    wholesale), and the slot is pending on the host."""
    je, jt, jd, te, tt, td, tcfg = pair
    rng = np.random.default_rng(21)
    old = rng.integers(0, tcfg.vocab_size, 40).astype(np.int32)
    other = rng.integers(0, tcfg.vocab_size, 12).astype(np.int32)
    feed = rng.integers(0, tcfg.vocab_size, 21).astype(np.int32)
    toks = np.ones((32,), np.int32)
    toks[:21] = feed
    states = []
    for eng, tp, dp in ((je, jt, jd), (te, tt, td)):
        st_ = eng.init_slots(3, 48, block_size=BLOCK)
        st_ = eng.prefill_into(tp, dp, st_, 0, other, 12, 48)
        st_ = eng.prefill_into(tp, dp, st_, 1, old, 40, 48)
        st_ = eng.retire_slot(st_, 1)
        st_ = eng.attach_prefix(dp, st_, 1, toks, 16, 21)
        assert st_.paged.is_pending(1)
        states.append(st_)
    js, ts = states
    np.testing.assert_array_equal(ts.seq_lens.numpy(), np.asarray(js.seq_lens))
    assert int(ts.seq_lens[1]) == 21
    for name in ("k", "v"):
        np.testing.assert_allclose(ts.dcache[name].numpy(), np.asarray(js.dcache[name]), **TOL)
    np.testing.assert_array_equal(ts.dcache["pos"].numpy(), np.asarray(js.dcache["pos"]))
    # rows past min(n_prefix, total - 2) = 16 are unwritten: no stale key
    assert (ts.dcache["pos"].numpy()[1, 16:] == -1).all()


@pytest.mark.parametrize("method", ["attach_prefix", "commit_attached"])
def test_warm_attach_calls_leave_the_state_untouched(engine, method):
    """``warm=True`` only loads the kernels (nothing on the CPU); on a
    contiguous pool both calls raise."""
    eng, tp, dp, tcfg = engine
    state = eng.init_slots(2, 48, block_size=BLOCK)
    p = np.arange(9, dtype=np.int32) + 1
    state = eng.prefill_into(tp, dp, state, 0, p, 9, 48)
    before = (copy.deepcopy(state.tcache), copy.deepcopy(state.dcache), state.seq_lens.clone(),
              copy.deepcopy(state.paged))
    args = {"attach_prefix": (dp, state, 1, np.ones((16,), np.int32), 8, 10),
            "commit_attached": (state, 1, 10, p[:2])}[method]
    state = getattr(eng, method)(*args, warm=True)
    assert all(torch.equal(state.tcache[n], before[0][n]) for n in before[0])
    assert all(torch.equal(state.dcache[n], before[1][n]) for n in before[1])
    assert torch.equal(state.seq_lens, before[2])
    np.testing.assert_array_equal(state.paged.device_tables(), before[3].device_tables())
    assert state.paged.free_blocks == before[3].free_blocks and not state.paged.is_pending(1)
    ring = eng.init_slots(2, 48)
    ring_args = (dp, ring) + args[2:] if method == "attach_prefix" else (ring,) + args[1:]
    with pytest.raises(ValueError, match="paged"):
        getattr(eng, method)(*ring_args)


def _donor(eng, tp, dp, vocab, num_blocks=None):
    """A pool with a cache whose only content is the 3 full blocks of a
    25-token donor prompt, held by the cache alone."""
    prefix = np.random.default_rng(17).integers(0, vocab, 25).astype(np.int32)
    state = eng.init_slots(3, 48, block_size=BLOCK, num_blocks=num_blocks)
    pk = state.paged
    cache = PrefixCache(pk.pool)
    pk.attach_cache(cache)
    state = eng.prefill_into(tp, dp, state, 0, prefix, 25, 48)
    cache.insert(prefix[:24], pk.table(0)[:3])
    state = eng.retire_slot(state, 0)
    return state, cache, prefix


def _attach_commit(eng, dp, state, cache, slot, prompt):
    """Zero-suffix admission as the live backend does it."""
    pk = state.paged
    blocks = cache.lock(prompt)
    n_prefix = len(blocks) * BLOCK
    assert n_prefix >= len(prompt) - 1
    pk.attach(slot, blocks, n_prefix)
    cache.unlock(blocks)
    toks = np.ones((32,), np.int32)
    toks[:len(prompt)] = prompt
    state = eng.attach_prefix(dp, state, slot, toks, n_prefix, len(prompt))
    return eng.commit_attached(state, slot, len(prompt), prompt[-2:])


def _chunk_admit(eng, tp, dp, state, slot, prompt, chunk=8):
    cur, total = 0, len(prompt)
    while cur < total - 1:
        n = min(chunk, total - 1 - cur)
        toks = np.ones((chunk,), np.int32)
        toks[:n] = prompt[cur:cur + n]
        final = cur + n == total - 1
        state = eng.prefill_chunk_into(tp, dp, state, slot, toks, cur, n, total,
                                       last2=prompt[-2:] if final else None)
        cur += n
    return state


def _slot_rows(state, slot, n):
    """K, V and pos of a slot's first n rows through its table."""
    ids = torch.tensor(state.paged.table(slot))
    out = {k: state.tcache[k][:, ids].flatten(1, 2)[:, :n] for k in ("k", "v")}
    out["pos"] = state.tcache["pos"][ids].flatten()[:n]
    return out


@pytest.mark.parametrize("length", [17, 16], ids=["no_copy", "copy"])
def test_zero_suffix_commit_equals_a_chunked_admission(engine, length):
    """A prompt covered by the cache up to its last feed row (17 tokens,
    16 cached: the first decode row lands in a fresh block) or whole (16
    of 16: row 15 lives in a shared block, copied on write): after
    commit_attached the slot's row state equals a chunked admission's bit
    for bit, its rows and draft rows agree, and both decode the same
    tokens.  With the copy: the copy's rows equal the source's, the source
    block is bit for bit unchanged after the slot's first decode step, and
    the cache still indexes it."""
    eng, tp, dp, tcfg = engine
    state, cache, prefix = _donor(eng, tp, dp, tcfg.vocab_size)
    prompt = prefix[:length]
    pk = state.paged
    src = cache.match(prompt)[1]
    snap = {k: state.tcache[k][:, src].clone() if k != "pos" else state.tcache[k][src].clone()
            for k in ("k", "v", "pos")}
    state = _attach_commit(eng, dp, state, cache, 1, prompt)
    ref = _chunk_admit(eng, tp, dp, eng.init_slots(3, 48, block_size=BLOCK), 1, prompt)
    for name in ("seq_lens", "last2", "out", "n_generated", "done"):
        assert torch.equal(getattr(state, name)[1], getattr(ref, name)[1]), name
    assert pk.tokens(1) == ref.paged.tokens(1) == length
    assert not pk.is_pending(1) and pk.allocated(1) == ref.paged.allocated(1)
    np.testing.assert_array_equal(state.tcache["bt"][1].numpy(), pk.device_tables()[1])
    got, want = _slot_rows(state, 1, length - 1), _slot_rows(ref, 1, length - 1)
    assert torch.equal(got["pos"], want["pos"])
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL)
    # the draft ring: the same positions, and the same K/V in the rows they
    # mark (the attach's B = 1 prefill also fills the rows it leaves at -1)
    assert torch.equal(state.dcache["pos"][1], ref.dcache["pos"][1])
    live = ref.dcache["pos"][1] >= 0
    assert int(live.sum()) == length - 2
    for k in ("k", "v"):
        np.testing.assert_allclose(state.dcache[k][:, 1, live].numpy(),
                                   ref.dcache[k][:, 1, live].numpy(), **TOL)
    if length == 16:
        dst = pk.table(1)[1]
        assert dst != src and cache.match(prompt)[1] == src
        for k in ("k", "v"):
            assert torch.equal(state.tcache[k][:, dst], snap[k])
        assert torch.equal(state.tcache["pos"][dst], snap["pos"])
    outs = []
    for route, st_ in enumerate((state, ref)):
        for i in range(30):
            st_, _ = eng.step(tp, dp, st_, 3)
            if route == 0 and i == 0:
                for k in ("k", "v", "pos"):   # the source block is untouched
                    cur = st_.tcache[k][:, src] if k != "pos" else st_.tcache[k][src]
                    assert torch.equal(cur, snap[k]), k
            if bool(st_.done[1]):
                break
        outs.append(st_.out[1].numpy()[:eng.max_new])
    np.testing.assert_array_equal(outs[0], outs[1])


def _check_pool(state, cache):
    """The standing invariant behind the wipe: a block on the free list
    carries no position, and a block held at logical index j (by a slot
    table, or by the cache at trie depth j) carries in row o either no
    position or position j * block_size + o, never a stale one."""
    pk = state.paged
    pos = state.tcache["pos"].numpy()
    where = {}
    for slot in range(pk.capacity):
        for j, b in enumerate(pk.table(slot)):
            where.setdefault(b, set()).add(j)
    stack = [(n, 0) for n in cache._root.children.values()]
    while stack:
        node, depth = stack.pop()
        where.setdefault(node.block, set()).add(depth)
        stack.extend((c, depth + 1) for c in node.children.values())
    for b in range(pk.num_blocks):
        if b not in where:
            assert (pos[b] == -1).all(), f"free block {b} carries positions {pos[b]}"
            continue
        (j,) = where[b]
        ok = (pos[b] == -1) | (pos[b] == j * BLOCK + np.arange(BLOCK))
        assert ok.all(), f"block {b} at logical block {j} carries stale positions {pos[b]}"


def _evicting(eng, tp, dp, vocab, free):
    """``_donor``'s cache (blocks at logical 0-2, positions 0-23, held by
    the cache alone) with slot 2 holding a 40-token prompt (5 blocks, at a
    block boundary) and ``free`` blocks on the free list."""
    state, cache, prefix = _donor(eng, tp, dp, vocab, num_blocks=3 + 5 + free)
    filler = np.random.default_rng(18).integers(0, vocab, 40).astype(np.int32)
    state = eng.prefill_into(tp, dp, state, 2, filler, 40, 48)
    assert state.paged.free_blocks == free and cache.reclaimable() == 3
    return state, cache, prefix


def _chunk(eng, tp, dp, state, prompt, start, n, **kw):
    """A chunk of exactly n tokens: no padded column writes the rows after
    it, so a stale row there stays in sight."""
    return eng.prefill_chunk_into(tp, dp, state, 1, prompt[start:start + n].copy(), start, n,
                                  len(prompt), **kw)


def _other(prefix, n):
    """An n-token prompt that shares no block with the cached prefix."""
    return prefix[::-1][:n].copy()


def _site_prefill_into(eng, tp, dp, state, cache, prefix):
    return eng.prefill_into(tp, dp, state, 1, _other(prefix, 20), 20, 48)


def _site_chunk_first(eng, tp, dp, state, cache, prefix):
    return _chunk(eng, tp, dp, state, _other(prefix, 20), 0, 5)


def _setup_chunk_next(eng, tp, dp, state, cache, prefix):
    return _chunk(eng, tp, dp, state, _other(prefix, 20), 0, 8)


def _site_chunk_next(eng, tp, dp, state, cache, prefix):
    return _chunk(eng, tp, dp, state, _other(prefix, 20), 8, 5)


def _setup_chunk_final(eng, tp, dp, state, cache, prefix):
    prompt = _other(prefix, 25)
    state = _chunk(eng, tp, dp, state, prompt, 0, 8)
    return _chunk(eng, tp, dp, state, prompt, 8, 8)


def _site_chunk_final(eng, tp, dp, state, cache, prefix):
    prompt = _other(prefix, 25)
    return _chunk(eng, tp, dp, state, prompt, 16, 8, last2=prompt[-2:])


def _site_commit_attached(eng, tp, dp, state, cache, prefix):
    return _attach_commit(eng, dp, state, cache, 1, prefix[:9].copy())


def _site_step(eng, tp, dp, state, cache, prefix):
    return eng.step(tp, dp, state, 3)[0]


def _site_step_with_chunk(eng, tp, dp, state, cache, prefix):
    state, chunk = _chunk(eng, tp, dp, state, _other(prefix, 20), 0, 8, defer=True)
    return eng.step_with_chunk(tp, dp, state, 3, chunk)[0]


# site: (free blocks, setup before the call or None, the call).  Each call
# evicts the leaf of the cached chain (positions 16-23) into a slot at
# another logical block, where a stale row would show.
SITES = {
    "prefill_into": (1, None, _site_prefill_into),
    "chunk_first": (0, None, _site_chunk_first),
    "chunk_next": (1, _setup_chunk_next, _site_chunk_next),
    "chunk_final": (3, _setup_chunk_final, _site_chunk_final),
    "commit_attached": (0, None, _site_commit_attached),
    "step": (0, None, _site_step),
    "step_with_chunk": (1, None, _site_step_with_chunk),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_evicted_blocks_are_wiped_after_each_allocation(engine, site):
    """Each host allocation of the engine that evicts a cache block wipes
    its pos rows before anything attends them: after the call the list of
    pending evictions is empty and no block carries a stale position (the
    evicted block, positions 16-23 at logical block 2, lands at another
    logical block, where a stale row would show).  ``prefill_into``
    overwrites every row of the blocks it allocates, so there the wipe has
    nothing to show; at the other six sites the check fails without it."""
    eng, tp, dp, tcfg = engine
    free, setup, call = SITES[site]
    state, cache, prefix = _evicting(eng, tp, dp, tcfg.vocab_size, free)
    if setup is not None:
        state = setup(eng, tp, dp, state, cache, prefix)
    pk = state.paged
    before = pk.evicted_total
    _check_pool(state, cache)
    state = call(eng, tp, dp, state, cache, prefix)
    assert pk.evicted_total > before, "the call evicted nothing: the test lost its bite"
    assert pk.evicted_pending == []
    _check_pool(state, cache)
