"""The port's slot and block-pool bookkeeping (``serving/slots.py``, host
numpy code copied from the JAX package) against the JAX package's: the same
random sequence of allocator, table and slot operations gives the same
tables, free lists, refcounts, token counts and errors in both, after every
operation.  Also the allocator unit tests of ``tests/test_paged_kv.py`` on
the port.  Exact equality throughout: there is no arithmetic to round.
"""
import numpy as np
import pytest

from repro.serving import slots as jslots
from repro.serving.request import Request as JRequest
from repro_torch.serving import slots
from repro_torch.serving.request import Request


def _snapshot(kv):
    return (kv.device_tables().tolist(), kv.device_tables(exclude_pending=True).tolist(),
            list(kv.pool._free), list(kv.pool._refs),
            [kv.tokens(s) for s in range(kv.capacity)], sorted(kv._pending),
            kv.free_blocks, kv.pool.shared_count, kv.pool.exclusive_count,
            kv.fragmentation)


def _apply(kv, op, args):
    """Run one operation; returns its result or the name of the error."""
    try:
        return getattr(kv, op)(*args) if op != "incref" else kv.pool.incref(*args)
    except (RuntimeError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_random_table_operations_match_jax(seed):
    rng = np.random.default_rng(seed)
    geo = dict(num_blocks=int(rng.integers(8, 24)), block_size=int(rng.choice([4, 8])),
               capacity=int(rng.integers(2, 6)), max_blocks_per_slot=4)
    kvs = (slots.PagedKVTables(**geo), jslots.PagedKVTables(**geo))
    bs = geo["block_size"]
    for _ in range(300):
        slot = int(rng.integers(geo["capacity"]))
        other = int(rng.integers(geo["capacity"]))
        op = rng.choice(["prefill", "ensure", "commit", "release", "attach", "cow",
                         "pending", "clear_pending", "incref"])
        if op == "prefill":
            args = (slot, int(rng.integers(1, 5 * bs)))
        elif op == "ensure":
            args = (slot, kvs[0].tokens(slot) + int(rng.integers(0, 2 * bs)))
        elif op == "commit":
            args = (slot, int(rng.integers(0, 4)))
        elif op == "release":
            args = (slot,)
        elif op == "attach":
            n = min(kvs[0].allocated(other), int(rng.integers(1, 3)))
            args = (slot, kvs[0].table(other)[:n], n * bs)
        elif op == "cow":
            op, lo = "cow_for_range", int(rng.integers(0, 3 * bs))
            args = (slot, lo, lo + int(rng.integers(0, 2 * bs)))
        elif op == "pending":
            op, args = "mark_pending", (slot,)
        elif op == "clear_pending":
            args = (slot,)
        else:
            table = kvs[0].table(slot)
            if not table:
                continue
            args = (table[int(rng.integers(len(table)))],)
        got, want = (_apply(kv, op, args) for kv in kvs)
        assert got == want, (op, args)
        assert _snapshot(kvs[0]) == _snapshot(kvs[1]), (op, args)
        kvs[0].pool.check_invariants()


@pytest.mark.parametrize("seed", range(3))
def test_random_slot_pool_operations_match_jax(seed):
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(1, 6))
    pools = (slots.SlotPool(cap), jslots.SlotPool(cap))
    for rid in range(200):
        op = rng.choice(["claim", "retire", "consume"])
        slot = int(rng.integers(cap))
        results = []
        for pool, R in zip(pools, (Request, JRequest)):
            try:
                if op == "claim":
                    req = R(rid=rid, arrival=0.0, tokens=np.ones(4, np.int32),
                            prompt_len=4, max_new=16)
                    req.n_generated = rid % 5
                    results.append(pool.claim(req))
                elif op == "retire":
                    results.append(pool.retire(slot).rid)
                else:
                    results.append(pool.consume(slot, rid % 3))
            except RuntimeError as e:
                results.append(str(e))
        assert results[0] == results[1], op
        for pool in pools:
            assert pool.occupancy == cap - pool.free_count
        assert pools[0].active_slots() == pools[1].active_slots()
        assert [pools[0].remaining(s) for s in range(cap)] == \
            [pools[1].remaining(s) for s in range(cap)]


# ---------------------------------------------------------------------------
# the allocator unit tests of tests/test_paged_kv.py, on the port


def test_block_pool_alloc_free_cycle():
    pool = slots.BlockPool(6, 8)
    assert pool.blocks_for(1) == 1 and pool.blocks_for(8) == 1
    assert pool.blocks_for(9) == 2 and pool.blocks_for(48) == 6
    assert pool.alloc(3) == [0, 1, 2]            # lowest-id-first
    assert pool.free_count == 3 and pool.used_count == 3
    pool.free([1])
    assert pool.alloc(2) == [1, 3]               # freed block reused first
    with pytest.raises(slots.BlockPoolExhausted):
        pool.alloc(3)
    with pytest.raises(ValueError):
        slots.BlockPool(0, 8)
    with pytest.raises(ValueError):
        slots.BlockPool(4, 0)


def test_block_pool_fragmentation_reuse():
    pool = slots.BlockPool(8, 4)
    a = pool.alloc(4)
    b = pool.alloc(2)
    pool.free([a[0], a[2], b[1]])                # holes at 0, 2, 5
    c = pool.alloc(4)
    assert c == [0, 2, 5, 6]                     # holes first, then fresh
    held = {a[1], a[3], b[0], *c}
    assert len(held) == 7 and pool.free_count == 1
    pool.free(sorted(held))
    assert pool.alloc(8) == list(range(8))


def test_refcounts_free_only_at_zero():
    pool = slots.BlockPool(4, 4)
    (blk,) = pool.alloc(1)
    assert pool.incref(blk) == 2 and pool.shared_count == 1
    assert pool.free([blk]) == [] and pool.free_count == 3
    assert pool.decref(blk) is True and pool.free_count == 4
    with pytest.raises(RuntimeError, match="double-free"):
        pool.decref(blk)
    with pytest.raises(RuntimeError, match="incref on free block"):
        pool.incref(blk)
    pool.check_invariants()


def test_paged_tables_lifecycle():
    kv = slots.PagedKVTables(num_blocks=10, block_size=4, capacity=3,
                             max_blocks_per_slot=4)
    assert kv.logical_len == 16
    kv.prefill(0, 7)
    assert kv.allocated(0) == 2 and kv.tokens(0) == 7 and kv.free_blocks == 8
    assert kv.ensure(0, 8) == []
    assert len(kv.ensure(0, 9)) == 1 and kv.allocated(0) == 3
    kv.commit(0, 2)
    assert kv.tokens(0) == 9
    with pytest.raises(RuntimeError):
        kv.prefill(0, 4)
    with pytest.raises(ValueError):
        kv.prefill(1, 17)
    tbl = kv.device_tables()
    assert tbl.shape == (3, 4) and (tbl[0, :3] >= 0).all() and tbl[0, 3] == -1
    assert (tbl[1:] == -1).all()
    assert len(kv.release(0)) == 3 and kv.free_blocks == 10
    assert kv.active_slots() == []
    kv.prefill(1, 16)
    assert kv.allocated(1) == 4
    with pytest.raises(ValueError, match="could not hold even one"):
        slots.PagedKVTables(num_blocks=3, block_size=4, capacity=2,
                            max_blocks_per_slot=4)


def test_slot_pool_claim_resumes_preempted_budget():
    pool = slots.SlotPool(2)
    req = Request(rid=0, arrival=0.0, tokens=np.arange(8, dtype=np.int32),
                  prompt_len=8, max_new=16)
    req.n_generated = 5
    assert pool.remaining(pool.claim(req)) == 11


@pytest.mark.parametrize("n_shards", [2, 4])
def test_host_shard_queue_matches_jax(n_shards):
    """The same claims and retirements place requests in the same slots."""
    from repro.serving.scheduler import HostShardQueue as JHostShardQueue
    from repro_torch.serving.scheduler import HostShardQueue
    rng = np.random.default_rng(n_shards)
    cap = 4 * n_shards
    sides = [(HostShardQueue(cap, n_shards), slots.SlotPool(cap), Request),
             (JHostShardQueue(cap, n_shards), jslots.SlotPool(cap), JRequest)]
    for rid in range(120):
        retire = rng.random() < 0.4
        slot = int(rng.integers(cap))
        results = []
        for q, pool, R in sides:
            try:
                if retire:
                    results.append(pool.retire(slot).rid)
                else:
                    results.append(q.claim(pool, R(rid=rid, arrival=0.0,
                                                   tokens=np.ones(4, np.int32),
                                                   prompt_len=4, max_new=8)))
            except RuntimeError as e:
                results.append(str(e))
        assert results[0] == results[1], (rid, retire, slot)
    with pytest.raises(ValueError):
        HostShardQueue(6, 4)
