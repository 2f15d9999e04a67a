"""The mixed verify+chunk launch in the port against the JAX package, on the
CPU.

* ``DecoderLM.decode_step_mixed`` against JAX's on the same weights and
  pool: a paged pool with a verify slot whose table has a hole, an empty
  slot, and a pending slot carrying a chunk (one that ends mid-block, one
  that runs over a hole of its own host table), at s 0 and 3, on the yi
  (GQA) and opt smoke configs.  Compared: the verify logits of the other
  slots, the pool rows below the port's trash block, and the device table
  (the chunk row still -1);
* ``SpecDecodeEngine.step_with_chunk`` against the port's own
  ``flush_chunk`` + ``step`` and against JAX's ``step_with_chunk``, on the
  setup of ``tests/test_ragged_paged_attn.py``;
* ``serve_continuous_live(mixed_launch=True)`` against the run without it
  (port of ``tests/test_ragged_paged_attn.py``'s chunked and
  chunked+preempt cases; arrivals at 0, since the live clock advances by
  wall time), and one mixed run on the JAX and the port engines;
* a deferred chunk lands before ``preempt``, ``retire``, ``output_for``,
  ``prefill`` or ``prefill_chunk`` touches the pool;
* the ``ValueError``s of JAX's contract.

Tolerances: fp32 logits and K/V rows 1e-5 (absolute plus relative);
``pos``, block tables, counts and every integer state exact; tokens equal.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import SpeculationLUT as JLUT
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models.transformer import DecoderLM as JDecoderLM
from repro.serving import scheduler as jsched
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core.adaptive import AdaptiveController, SpeculationLUT
from repro_torch.core.spec_decode import DeferredChunk, SpecDecodeEngine
from repro_torch.kernels import tuning
from repro_torch.models.transformer import DecoderLM
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend,
                                           PrefillBudgetAdmit,
                                           serve_continuous_live)
from repro_torch.serving.traffic import TrafficPhase, make_requests

TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_LEN = 96
BLOCK = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny CPU ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the model: decode_step_mixed


def _models(arch):
    """Both decoders on the JAX-initialised weights of a smoke config."""
    jm, tm = JDecoderLM(JR.get_smoke_config(arch)), DecoderLM(R.get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


NB, MAXB = 16, 6
CHUNK_CASES = {
    # (the chunk slot's host table row, chunk start, chunk limit): prefix
    # rows 0..15 in blocks 2 and 12; the chunk's 16 columns at 16..31
    "mid_block": ([2, 12, 6, 14, -1, -1], 16, 27),     # ends 3 rows into block 14
    "table_hole": ([2, 12, -1, 14, -1, -1], 16, 32),   # rows 16..23 land in no block
}


def _mixed_pool(tm, case, seed=0):
    """A pool as numpy: random K/V and garbage positions everywhere.  Slot 0
    verifies at seq_len 20 through [3, 7, 11]; slot 1 at seq_len 14 through
    [5, -1, 9], a hole over rows 8..15 (its rows 13..15 write nowhere);
    slot 2 is pending, device row -1, its host row of ``CHUNK_CASES``
    holding the prefix 0..15; slot 3 is empty."""
    rng = np.random.default_rng(seed)
    a = tm.cfg.attn
    shape = (tm.cfg.n_layers, NB, BLOCK, a.n_kv_heads, a.head_dim)
    bt = np.full((4, MAXB), -1, np.int32)
    bt[0, :3] = [3, 7, 11]
    bt[1, :3] = [5, -1, 9]
    host_row = np.asarray(CHUNK_CASES[case][0], np.int32)
    pos = rng.integers(0, 200, (NB, BLOCK)).astype(np.int32)
    for row, n in ((bt[0], 19), (bt[1], 13), (host_row, 16)):
        for j, pb in enumerate(row):
            if pb >= 0:
                rows = j * BLOCK + np.arange(BLOCK)
                pos[pb] = np.where(rows < n, rows, -1)
    return dict(k=(0.5 * rng.standard_normal(shape)).astype(np.float32),
                v=(0.5 * rng.standard_normal(shape)).astype(np.float32), pos=pos,
                bt=bt), host_row


def _port_pool(c):
    """The port's pool carries one trash block past the JAX pool's NB."""
    out = {"bt": torch.from_numpy(c["bt"].copy())}
    for name in ("k", "v"):
        out[name] = torch.from_numpy(
            np.concatenate([c[name], np.zeros_like(c[name][:, :1])], axis=1))
    out["pos"] = torch.from_numpy(np.concatenate([c["pos"], np.full_like(c["pos"][:1], -1)]))
    return out


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
@pytest.mark.parametrize("s", [0, 3])
@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_decode_step_mixed_matches_jax(arch, s, case):
    jm, jp, tm, tp = _models(arch)
    c, host_row = _mixed_pool(tm, case)
    _, start, limit = CHUNK_CASES[case]
    CB, vl = 16, s + 1
    Tm = max(vl, CB)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab_size, (4, Tm)).astype(np.int32)
    ctoks = rng.integers(0, tm.cfg.vocab_size, (CB,)).astype(np.int32)
    seq_lens = np.array([20, 14, 40, 2], np.int32)   # the pending slot parked at 40
    eff = c["bt"].copy()
    eff[2] = host_row
    cu = tuning.host_cu_blocks(eff)
    jl, jc = jax.jit(jm.decode_step_mixed, static_argnums=(9,))(
        jp, jnp.asarray(toks), {n: jnp.asarray(x) for n, x in c.items()},
        jnp.asarray(seq_lens), jnp.int32(2), jnp.asarray(ctoks), jnp.int32(start),
        jnp.int32(limit), jnp.asarray(host_row), vl, jnp.asarray(cu))
    tc = _port_pool(c)
    tl, tc = tm.decode_step_mixed(tp, torch.from_numpy(toks), tc, torch.from_numpy(seq_lens),
                                  2, torch.from_numpy(ctoks), start, limit,
                                  torch.from_numpy(host_row), vl, torch.from_numpy(cu))
    assert tuple(tl.shape[:2]) == (4, vl)
    live = [0, 1, 3]
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live, :vl], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy()[:NB], np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[:, :NB], np.asarray(jc[name]), **TOL)
    # the device table is not patched: the pending row stays -1
    np.testing.assert_array_equal(tc["bt"].numpy(), c["bt"])
    np.testing.assert_array_equal(np.asarray(jc["bt"]), c["bt"])
    # the chunk's real rows landed through its host row, the padding nowhere
    got = tc["pos"].numpy()
    for p in range(start, start + CB):
        pb = host_row[p // BLOCK]
        if pb >= 0:
            assert got[pb, p % BLOCK] == (p if p < limit else -1)


# ---------------------------------------------------------------------------
# the engine: step_with_chunk (the setup of tests/test_ragged_paged_attn.py)


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


def _mixed_setup(eng, tp, dp, vocab):
    """Two live decode slots plus one deferred (pending) prefill chunk."""
    rng = np.random.default_rng(5)
    p0 = rng.integers(0, vocab, (9,)).astype(np.int32)
    p1 = rng.integers(0, vocab, (13,)).astype(np.int32)
    long_p = rng.integers(0, vocab, (22,)).astype(np.int32)
    state = eng.init_slots(3, cache_len=CACHE_LEN, block_size=BLOCK)
    state = eng.prefill_into(tp, dp, state, 0, p0, len(p0), CACHE_LEN)
    state = eng.prefill_into(tp, dp, state, 1, p1, len(p1), CACHE_LEN)
    state, chunk = eng.prefill_chunk_into(tp, dp, state, 2, long_p[:8].copy(), 0, 8,
                                          len(long_p), defer=True)
    return state, chunk


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _states_match(a, b, st_a, st_b, nb, float_tol):
    """Counts and every integer leaf exact, K/V (pool below the trash block
    ``nb``, when given) within ``float_tol``."""
    np.testing.assert_array_equal(st_a.accepted, st_b.accepted)
    np.testing.assert_array_equal(st_a.committed, st_b.committed)
    for name in ("seq_lens", "last2", "out", "n_generated", "done"):
        np.testing.assert_array_equal(_host(getattr(a, name)), _host(getattr(b, name)),
                                      err_msg=name)
    for cache in ("tcache", "dcache"):
        ca, cb = getattr(a, cache), getattr(b, cache)
        for key in ca:
            x, y = _host(ca[key]), _host(cb[key])
            if cache == "tcache" and nb is not None and key != "bt":
                x = x[:nb] if key == "pos" else x[:, :nb]
                y = y[:nb] if key == "pos" else y[:, :nb]
            if key in ("pos", "bt"):
                np.testing.assert_array_equal(x, y, err_msg=f"{cache}[{key}]")
            else:
                np.testing.assert_allclose(x, y, err_msg=f"{cache}[{key}]", **float_tol)


@pytest.mark.parametrize("s", [0, 2])
def test_step_with_chunk_matches_flush_then_step(engine, s):
    """The one mixed launch leaves the state of the two-launch order (the
    chunk on its own, then the plain step), below the trash block; the
    pending slot's device row stays -1 and it commits nothing."""
    eng, tp, dp, tcfg = engine
    state_a, chunk_a = _mixed_setup(eng, tp, dp, tcfg.vocab_size)
    state_a = eng.flush_chunk(tp, dp, state_a, chunk_a)
    state_a, st_a = eng.step(tp, dp, state_a, s)
    state_b, chunk_b = _mixed_setup(eng, tp, dp, tcfg.vocab_size)
    state_b, st_b = eng.step_with_chunk(tp, dp, state_b, s, chunk_b)
    _states_match(state_a, state_b, st_a, st_b, state_b.paged.num_blocks, TOL)
    assert st_b.committed[2] == 0 and (state_b.tcache["bt"][2] == -1).all()
    assert state_b.paged.is_pending(2)
    np.testing.assert_array_equal(state_a.paged.device_tables(),
                                  state_b.paged.device_tables())


@pytest.mark.parametrize("s", [0, 2])
def test_step_with_chunk_matches_jax(pair, s):
    je, jt, jd, te, tt, td, tcfg = pair
    js, jchunk = _mixed_setup(je, jt, jd, tcfg.vocab_size)
    js, jst = je.step_with_chunk(jt, jd, js, s, jchunk)
    ts, tchunk = _mixed_setup(te, tt, td, tcfg.vocab_size)
    assert isinstance(tchunk, DeferredChunk)
    np.testing.assert_array_equal(tchunk.bt_row, jchunk.bt_row)
    ts, tst = te.step_with_chunk(tt, td, ts, s, tchunk)
    _states_match(ts, js, tst, jst, ts.paged.num_blocks, TOL)
    np.testing.assert_array_equal(ts.paged.device_tables(), js.paged.device_tables())


# ---------------------------------------------------------------------------
# the live backend and serve_continuous_live


def _ctrl(cls=AdaptiveController, lut=SpeculationLUT):
    return cls(lut=lut({1: 4, 2: 3, 4: 2}))


def _trace(vocab, cls=Request, n=8, seed=11):
    reqs = make_requests(n, [TrafficPhase(0.0005, 1.0, float("inf"))], vocab,
                         seed=seed, max_new=16)
    rng = np.random.default_rng(3)
    out = []
    for i, r in enumerate(reqs):
        # arrivals pinned to 0: the schedule must not depend on wall time,
        # or the faster mixed run would admit on another iteration
        tokens, plen = r.tokens, r.prompt_len
        max_new = int(rng.integers(10, 17))
        if i % 2 == 0:
            plen = int(rng.integers(24, 40))
            tokens = rng.integers(0, vocab, (plen,)).astype(np.int32)
        out.append(cls(rid=r.rid, arrival=0.0, tokens=tokens, prompt_len=plen,
                       max_new=max_new))
    return out


def _fused_steps(eng):
    """Count the engine's mixed steps and flushes by wrapping its methods."""
    n = Counter()
    for name in ("step_with_chunk", "flush_chunk"):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            n[_name] += 1
            return _fn(*a, **kw)
        setattr(eng, name, counted)
    return n


def _serve(eng, tp, dp, vocab, mixed, num_blocks, jax_side=False):
    mod = jsched if jax_side else None
    backend_cls = mod.ContinuousEngineBackend if jax_side else ContinuousEngineBackend
    serve = mod.serve_continuous_live if jax_side else serve_continuous_live
    policy = (mod.PrefillBudgetAdmit if jax_side else PrefillBudgetAdmit)(token_budget=16,
                                                                          chunk=8)
    ctrl = _ctrl(JController, JLUT) if jax_side else _ctrl()
    backend = backend_cls(eng, tp, dp, capacity=4, cache_len=CACHE_LEN, block_size=BLOCK,
                          num_blocks=num_blocks, collect_outputs=True, warm_s=(2, 3, 4),
                          mixed_launch=mixed)
    res = serve(_trace(vocab, JRequest if jax_side else Request), eng, tp, dp, ctrl,
                backend=backend, policy=policy)
    return backend, res


TRACE_FIELDS = ("occupancy", "s", "rids", "committed", "admitted", "preempted",
                "done_rids", "chunked")


@pytest.mark.parametrize("num_blocks,needs_preempt", [(40, False), (20, True)],
                         ids=["chunked", "chunked+preempt"])
def test_serve_mixed_launch_token_and_trace_parity(engine, num_blocks, needs_preempt):
    """Mixing on against off: tokens and every StepTrace field but the
    durations equal, through chunked admission and (undersized pool)
    preemption; chunks did ride steps."""
    eng, tp, dp, tcfg = engine
    b_off, r_off = _serve(eng, tp, dp, tcfg.vocab_size, False, num_blocks)
    fused = _fused_steps(eng)
    try:
        b_on, r_on = _serve(eng, tp, dp, tcfg.vocab_size, True, num_blocks)
    finally:
        for name in ("step_with_chunk", "flush_chunk"):
            del eng.__dict__[name]
    per_rid = Counter(rid for t in r_on.trace for rid, _ in t.chunked)
    assert per_rid and max(per_rid.values()) >= 3
    assert fused["step_with_chunk"] > 0, "no chunk rode a step"
    if needs_preempt:
        assert any(t.preempted for t in r_on.trace), \
            "pool was not under pressure; the preemption leg lost its bite"
    assert all(r.finish is not None and r.n_generated == r.max_new for r in r_on.requests)
    assert set(b_off.outputs) == set(b_on.outputs)
    for rid in b_off.outputs:
        np.testing.assert_array_equal(b_off.outputs[rid], b_on.outputs[rid],
                                      err_msg=f"rid {rid}")
    assert len(r_off.trace) == len(r_on.trace)
    for t0, t1 in zip(r_off.trace, r_on.trace):
        for f in TRACE_FIELDS:
            assert getattr(t0, f) == getattr(t1, f), f


def test_mixed_live_serving_matches_jax(pair):
    """One mixed run with preemption on the JAX and the port engines, on the
    same weights: equal traces and tokens per request."""
    je, jt, jd, te, tt, td, tcfg = pair
    jbe, jres = _serve(je, jt, jd, tcfg.vocab_size, True, 20, jax_side=True)
    tbe, tres = _serve(te, tt, td, tcfg.vocab_size, True, 20)
    assert any(t.chunked for t in tres.trace) and any(t.preempted for t in tres.trace)
    assert len(tres.trace) == len(jres.trace)
    for t0, t1 in zip(jres.trace, tres.trace):
        for f in TRACE_FIELDS:
            assert getattr(t0, f) == getattr(t1, f), f
    for r in tres.requests:
        np.testing.assert_array_equal(tbe.outputs[r.rid], np.asarray(jbe.outputs[r.rid]),
                                      err_msg=f"rid {r.rid}")


def _consumers():
    """(consumer, the engine method it reaches, or None for a read)."""
    return {
        "preempt": (lambda be, reqs: be.preempt(0, reqs[0]), "retire_slot"),
        "retire": (lambda be, reqs: be.retire(0, reqs[0]), "retire_slot"),
        "output_for": (lambda be, reqs: be.output_for(0, reqs[0]), None),
        "prefill": (lambda be, reqs: be.prefill(reqs[2], 2), "prefill_into"),
        "prefill_chunk": (lambda be, reqs: be.prefill_chunk(reqs[2], 2, 0, 8),
                          "prefill_chunk_into"),
    }


@pytest.mark.parametrize("consumer", sorted(_consumers()))
def test_deferred_chunk_lands_before_the_pool_is_touched(engine, consumer):
    """With a chunk deferred, each other consumer of the pool first sends it
    on its own: the flush comes before the consumer's engine call, and the
    chunk's rows are in the pool afterwards."""
    eng, tp, dp, tcfg = engine
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, arrival=0.0, tokens=rng.integers(0, tcfg.vocab_size, L)
                    .astype(np.int32), prompt_len=L, max_new=8)
            for i, L in enumerate((9, 30, 20))]
    be = ContinuousEngineBackend(eng, tp, dp, capacity=3, cache_len=CACHE_LEN,
                                 block_size=BLOCK, num_blocks=30, mixed_launch=True)
    be.prefill(reqs[0], 0)
    be.prefill_chunk(reqs[1], 1, 0, 8)
    assert isinstance(be._deferred, DeferredChunk)
    pk = be.state.paged
    rows = np.asarray(pk.table(1))
    assert (be.state.tcache["pos"][torch.from_numpy(rows)] == -1).all(), \
        "the deferred chunk's forward ran at feed time"
    calls = []
    fn, reached = _consumers()[consumer]
    for name in ("flush_chunk", "retire_slot", "prefill_into", "prefill_chunk_into"):
        orig = getattr(eng, name)

        def traced(*a, _orig=orig, _name=name, **kw):
            if not kw.get("warm"):
                calls.append(_name)
            return _orig(*a, **kw)
        setattr(eng, name, traced)
    try:
        fn(be, reqs)
    finally:
        for name in ("flush_chunk", "retire_slot", "prefill_into", "prefill_chunk_into"):
            del eng.__dict__[name]
    if consumer == "prefill_chunk":    # the new non-final chunk defers in turn
        assert be._deferred.slot == 2
    else:
        assert be._deferred is None
    assert calls[0] == "flush_chunk" and calls.count("flush_chunk") == 1, calls
    if reached is not None:
        assert reached in calls[1:], calls
    # the chunk's 8 rows (positions 0..7) are in its first block
    np.testing.assert_array_equal(be.state.tcache["pos"][int(rows[0])].numpy(),
                                  np.arange(8))


def _raises_contiguous_backend(eng, tp, dp, vocab):
    ContinuousEngineBackend(eng, tp, dp, capacity=2, cache_len=CACHE_LEN, mixed_launch=True)


def _raises_contiguous_step(eng, tp, dp, vocab):
    state = eng.init_slots(2, cache_len=CACHE_LEN)
    chunk = DeferredChunk(slot=1, tokens=np.ones(8, np.int32), start=0, total_len=20,
                          bt_row=None, cb=8, rows_limit=16)
    eng.step_with_chunk(tp, dp, state, 0, chunk)


def _raises_defer(paged, final=False, warm=False):
    def run(eng, tp, dp, vocab):
        state = eng.init_slots(2, cache_len=CACHE_LEN, block_size=BLOCK if paged else None)
        n = 19 if final else 8
        eng.prefill_chunk_into(tp, dp, state, 1, np.ones(32 if final else 8, np.int32), 0, n,
                               20, last2=[1, 1] if final else None, warm=warm, defer=True)
    return run


def _raises_explicit_backend(eng, tp, dp, vocab):
    be = ContinuousEngineBackend(eng, tp, dp, capacity=2, cache_len=CACHE_LEN,
                                 block_size=BLOCK, mixed_launch=True)
    serve_continuous_live(_trace(vocab, n=2), eng, tp, dp, _ctrl(), backend=be,
                          mixed_launch=True)


VALUE_ERRORS = {
    "backend_contiguous": (_raises_contiguous_backend, "paged KV pool"),
    "step_with_chunk_contiguous": (_raises_contiguous_step, "paged slot pool"),
    "defer_contiguous": (_raises_defer(False), "defer=True needs"),
    "defer_final": (_raises_defer(True, final=True), "defer=True needs"),
    "defer_warm": (_raises_defer(True, warm=True), "defer=True needs"),
    "explicit_backend": (_raises_explicit_backend, "explicit backend"),
}


@pytest.mark.parametrize("case", sorted(VALUE_ERRORS))
def test_mixed_launch_value_errors(engine, case):
    eng, tp, dp, tcfg = engine
    fn, match = VALUE_ERRORS[case]
    with pytest.raises(ValueError, match=match):
        fn(eng, tp, dp, tcfg.vocab_size)


def test_defer_then_flush_equals_the_chunk_forward(engine):
    """``defer=True`` then ``flush_chunk`` leaves the pool and row state of
    the chunk run at once, and the deferred chunk keeps the bookkeeping's
    table row and the forward's bounds."""
    eng, tp, dp, tcfg = engine
    rng = np.random.default_rng(4)
    long_p = rng.integers(0, tcfg.vocab_size, (22,)).astype(np.int32)
    out = []
    for defer in (False, True):
        state = eng.init_slots(2, cache_len=CACHE_LEN, block_size=BLOCK)
        for start in (0, 8):
            if defer:
                state, chunk = eng.prefill_chunk_into(tp, dp, state, 1, long_p[start:start + 8],
                                                      start, 8, 22, defer=True)
                assert (chunk.cb, chunk.start, chunk.total_len) == (8, start, 22)
                assert chunk.rows_limit == 16
                np.testing.assert_array_equal(chunk.bt_row[:len(state.paged.table(1))],
                                              state.paged.table(1))
                state = eng.flush_chunk(tp, dp, state, chunk)
            else:
                state = eng.prefill_chunk_into(tp, dp, state, 1, long_p[start:start + 8],
                                               start, 8, 22)
        out.append(state)
    a, b = out
    for key in ("k", "v", "pos", "bt"):
        assert torch.equal(a.tcache[key], b.tcache[key]), key
    for key in a.dcache:
        assert torch.equal(a.dcache[key], b.dcache[key]), key
    for name in ("seq_lens", "done"):
        assert torch.equal(getattr(a, name), getattr(b, name))
