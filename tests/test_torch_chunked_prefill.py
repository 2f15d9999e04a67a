"""Chunked prefill in the port against the JAX package, on the CPU.

* ``DecoderLM.prefill_chunk`` on a ring (a middle chunk, a ragged final
  chunk, with and without ``rows_limit``, and the ragged final chunk whose
  padded tail wraps onto row 0 of the ring) and on a paged pool whose table
  has holes, against JAX's ``prefill_chunk`` on the same weights and cache;
* the port's ``SpecDecodeEngine.prefill_chunk_into`` and the live backend's
  chunked admission (ports of ``tests/test_chunked_prefill.py``): chunked =
  whole-prompt = solo tokens, the StepTrace replayed on the sim backend,
  a chunk-admitted request later preempted;
* one paged ``serve_continuous_live`` run with chunking on the JAX engine and
  on the port's, on the same weights: equal traces and outputs.

Tolerances: fp32 logits 1e-5 (absolute plus relative), K/V rows the same,
``pos`` arrays exact, and rows outside a chunk's valid columns bit for bit
unchanged.  Tokens are equal, not close.
"""
import copy
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
from repro_torch.core.analytical import LatencyModel
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import tuning
from repro_torch.models.transformer import DecoderLM
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend,
                                           ContinuousScheduler,
                                           PrefillBudgetAdmit, SimStepBackend,
                                           replay_sources,
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


def _models(arch):
    """Both decoders on the JAX-initialised weights of a smoke config."""
    jm, tm = JDecoderLM(JR.get_smoke_config(arch)), DecoderLM(R.get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


# ---------------------------------------------------------------------------
# the model: prefill_chunk on a ring


def _ring(tm, B, L, prefix, rng):
    """A ring cache as numpy: random K/V in every row (so that a clobbered
    row shows), row p % L holding position p for p < prefix[b], the rest
    unwritten (-1)."""
    a = tm.cfg.attn
    shape = (tm.cfg.n_layers, B, L, a.n_kv_heads, a.head_dim)
    pos = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos[b, np.arange(prefix[b]) % L] = np.arange(prefix[b])
    return dict(k=(0.5 * rng.standard_normal(shape)).astype(np.float32),
                v=(0.5 * rng.standard_normal(shape)).astype(np.float32), pos=pos)


# (ring L, chunk T, offset [B], limit [B]); "wrap": offset + T > L, the padded
# tail of the ragged final chunk lands on rows 0.. that hold the live prefix
RING_CASES = {
    "middle": (48, 8, [16, 8], [40, 30]),
    "ragged_final": (48, 16, [16, 12], [21, 20]),
    "wrap": (24, 16, [16, 14], [20, 21]),
}


@pytest.mark.parametrize("rows_limit", [None, 32], ids=["all_rows", "rows_limit"])
@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_ring_prefill_chunk_matches_jax(arch, case, rows_limit):
    L, T, offset, limit = RING_CASES[case]
    R_ = None if rows_limit is None else min(rows_limit, L)
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(len(case))
    B = len(offset)
    c = _ring(tm, B, L, offset, rng)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    off, lim = np.asarray(offset, np.int32), np.asarray(limit, np.int32)
    jl, jc = jax.jit(jm.prefill_chunk, static_argnums=(5,))(
        jp, jnp.asarray(toks), {n: jnp.asarray(x) for n, x in c.items()},
        jnp.asarray(off), jnp.asarray(lim), R_)
    tc = {n: torch.from_numpy(x.copy()) for n, x in c.items()}
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), tc, torch.from_numpy(off),
                              torch.from_numpy(lim), rows_limit=R_)
    valid = (off[:, None] + np.arange(T)[None]) < lim[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
    # every row outside [offset, limit) is bit for bit as it was
    for b in range(B):
        written = np.arange(off[b], lim[b]) % L
        kept = np.setdiff1d(np.arange(L), written)
        np.testing.assert_array_equal(tc["pos"].numpy()[b, kept], c["pos"][b, kept])
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy()[:, b, kept], c[name][:, b, kept])
    if case == "wrap":   # the padded tail did reach live rows of the prefix
        assert all((np.arange(lim[b], off[b] + T) % L < off[b]).any() for b in range(B))


def test_ring_prefill_chunk_rejects_a_chunk_wider_than_the_ring():
    _, _, tm, tp = _models("yi-9b")
    c = tm.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tm.prefill_chunk(tp, torch.ones((1, 16), dtype=torch.long), c,
                         torch.zeros(1, dtype=torch.int32),
                         torch.full((1,), 4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the model: prefill_chunk on a paged pool


def _paged(tm, NB=12, bs=8, MAXB=6, seed=0):
    """A pool as numpy: random K/V and garbage positions everywhere; slot 0
    owns blocks [4, 1, 7, 10] for positions 0..23 written, slot 1 owns
    [2, -1, 9] (a hole at its second logical block) for 0..6."""
    rng = np.random.default_rng(seed)
    a = tm.cfg.attn
    shape = (tm.cfg.n_layers, NB, bs, a.n_kv_heads, a.head_dim)
    bt = np.full((2, MAXB), -1, np.int32)
    bt[0, :4] = [4, 1, 7, 10]
    bt[1, :3] = [2, -1, 9]
    pos = rng.integers(0, 200, (NB, bs)).astype(np.int32)
    for b, n in ((0, 24), (1, 7)):
        for j, pb in enumerate(bt[b]):
            if pb >= 0:
                rows = j * bs + np.arange(bs)
                pos[pb] = np.where(rows < n, rows, -1)
    return dict(k=(0.5 * rng.standard_normal(shape)).astype(np.float32),
                v=(0.5 * rng.standard_normal(shape)).astype(np.float32), pos=pos, bt=bt)


def _port_pool(c):
    """The port's pool carries one trash block past the JAX pool's NB."""
    out = {"bt": torch.from_numpy(c["bt"].copy())}
    for name in ("k", "v"):
        out[name] = torch.from_numpy(
            np.concatenate([c[name], np.zeros_like(c[name][:, :1])], axis=1))
    out["pos"] = torch.from_numpy(np.concatenate([c["pos"], np.full_like(c["pos"][:1], -1)]))
    return out


@pytest.mark.parametrize("arch", ["opt-6.7b", "yi-9b"])
def test_paged_prefill_chunk_matches_jax(arch):
    """Slot 0: a ragged final chunk at 24..39 with 5 real columns (the padded
    ones reach logical blocks past its table); slot 1: a chunk at 7..22
    running over the hole of its table (those writes are dropped)."""
    jm, jp, tm, tp = _models(arch)
    c = _paged(tm)
    NB, bs = c["pos"].shape
    T = 16
    off, lim = np.array([24, 7], np.int32), np.array([29, 23], np.int32)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (2, T)).astype(np.int32)
    cu = tuning.host_cu_blocks(c["bt"])
    jl, jc = jax.jit(jm.prefill_chunk)(
        jp, jnp.asarray(toks), {n: jnp.asarray(x) for n, x in c.items()},
        jnp.asarray(off), jnp.asarray(lim), None, jnp.asarray(cu))
    tc = _port_pool(c)
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), tc, torch.from_numpy(off),
                              torch.from_numpy(lim), cu_blocks=torch.from_numpy(cu))
    valid = (off[:, None] + np.arange(T)[None]) < lim[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy()[:NB], np.asarray(jc["pos"]))
    written = set()
    for b in range(2):
        for p in range(off[b], lim[b]):
            pb = c["bt"][b, p // bs]
            if pb >= 0:
                written.add((int(pb), p % bs))
    for pb in range(NB):
        for o in range(bs):
            for name in ("k", "v"):
                got, want = tc[name].numpy()[:, pb, o], np.asarray(jc[name])[:, pb, o]
                if (pb, o) in written:
                    np.testing.assert_allclose(got, want, **TOL)
                else:   # every other row of the real blocks is bit for bit as it was
                    np.testing.assert_array_equal(got, c[name][:, pb, o])
    np.testing.assert_array_equal(tc["bt"].numpy(), c["bt"])


# ---------------------------------------------------------------------------
# the engine and the scheduler (ports of tests/test_chunked_prefill.py)


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


def _model(bs=(1, 2, 4)):
    return LatencyModel(alpha={b: 1e-4 for b in bs}, beta={b: 5e-3 for b in bs},
                        t_s={b: 2e-4 for b in bs}, c=0.9, gamma=0.548)


def _solo(eng, tp, dp, prompt):
    out, _, _ = eng.generate(tp, dp, np.asarray(prompt)[None, :],
                             np.array([len(prompt)], np.int32), s=3, cache_len=CACHE_LEN)
    return out[0]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_prefill_chunk_into_matches_whole_prefill(engine, paged):
    """A prompt fed across >= 3 chunks, with decode steps of another slot
    between the chunks, gives the tokens of a whole-prompt admission and
    leaves the companion slot undisturbed."""
    eng, tp, dp, tcfg = engine
    rng = np.random.default_rng(3)
    long_p = rng.integers(0, tcfg.vocab_size, (22,)).astype(np.int32)
    short_p = rng.integers(0, tcfg.vocab_size, (7,)).astype(np.int32)
    refs = {"long": _solo(eng, tp, dp, long_p), "short": _solo(eng, tp, dp, short_p)}
    state = eng.init_slots(3, cache_len=CACHE_LEN, block_size=BLOCK if paged else None)
    state = eng.prefill_into(tp, dp, state, 0, short_p, 7, CACHE_LEN)
    total = len(long_p)
    feed_total = total - 1                       # 21 tokens -> 3 chunks of 8
    cur, n_chunks = 0, 0
    while cur < feed_total:
        m = min(8, feed_total - cur)
        toks = np.ones((8,), np.int32)
        toks[:m] = long_p[cur:cur + m]
        final = cur + m == feed_total
        state = eng.prefill_chunk_into(tp, dp, state, 1, toks, cur, m, total,
                                       last2=long_p[-2:] if final else None)
        cur += m
        n_chunks += 1
        if paged:   # the device table row stays -1 until the final chunk
            assert (state.tcache["bt"][1] == -1).all().item() != final
            assert state.paged.is_pending(1) != final
        if not final:
            assert bool(state.done[1]) and int(state.seq_lens[1]) == total   # parked
            state, st = eng.step(tp, dp, state, 3)
            assert st.committed[1] == 0 and st.committed[2] == 0
    assert n_chunks >= 3
    assert not bool(state.done[1]) and int(state.n_generated[1]) == 0
    np.testing.assert_array_equal(state.last2[1].numpy(), long_p[-2:])
    if paged:
        assert state.paged.tokens(1) == total
        np.testing.assert_array_equal(state.tcache["bt"].numpy()[1],
                                      state.paged.device_tables()[1])
    for _ in range(40):
        state, _ = eng.step(tp, dp, state, 3)
        if bool(state.done[:2].all()):
            break
    out = state.out.numpy()[:, :eng.max_new]
    np.testing.assert_array_equal(out[1], refs["long"], err_msg="chunked slot diverged")
    np.testing.assert_array_equal(out[0], refs["short"],
                                  err_msg="companion slot was disturbed")


def test_prefill_chunk_into_validates_args(engine):
    eng, tp, dp, tcfg = engine
    state = eng.init_slots(2, cache_len=CACHE_LEN)
    toks = np.ones((8,), np.int32)
    with pytest.raises(ValueError, match="bucket"):
        eng.prefill_chunk_into(tp, dp, state, 0, toks, 0, 0, 20)
    with pytest.raises(ValueError, match="overruns"):
        eng.prefill_chunk_into(tp, dp, state, 0, toks, 16, 8, 20)
    with pytest.raises(ValueError, match="last2"):
        # final chunk (start + n == total_len - 1) without last2
        eng.prefill_chunk_into(tp, dp, state, 0, toks, 11, 8, 20)


def test_warm_chunk_leaves_the_state_untouched(engine):
    eng, tp, dp, tcfg = engine
    state = eng.init_slots(2, cache_len=CACHE_LEN, block_size=BLOCK)
    p = np.arange(9, dtype=np.int32) + 1
    state = eng.prefill_into(tp, dp, state, 0, p, 9, CACHE_LEN)
    before = (copy.deepcopy(state.tcache), copy.deepcopy(state.dcache),
              state.seq_lens.clone(), state.paged.device_tables().copy(),
              state.paged.free_blocks)
    state = eng.prefill_chunk_into(tp, dp, state, 1, np.ones((8,), np.int32), 0, 8, 10,
                                   warm=True)
    assert all(torch.equal(state.tcache[n], before[0][n]) for n in before[0])
    assert all(torch.equal(state.dcache[n], before[1][n]) for n in before[1])
    assert torch.equal(state.seq_lens, before[2])
    np.testing.assert_array_equal(state.paged.device_tables(), before[3])
    assert state.paged.free_blocks == before[4]


def _trace(vocab, n=10, seed=7, long_every=3, long_len=(30, 40), budget=(4, 17),
           cls=Request):
    reqs = make_requests(n, [TrafficPhase(0.0005, 1.0, float("inf"))], vocab,
                         seed=seed, max_new=16)
    rng = np.random.default_rng(3)
    out = []
    for i, r in enumerate(reqs):
        max_new = int(rng.integers(*budget))
        tokens, plen = r.tokens, r.prompt_len
        if i % long_every == 0:
            plen = int(rng.integers(*long_len))
            tokens = rng.integers(0, vocab, (plen,)).astype(np.int32)
        out.append(cls(rid=r.rid, arrival=r.arrival, tokens=tokens, prompt_len=plen,
                       max_new=max_new))
    return out


def _replay(res, **simkw):
    """A sim scheduler that replays ``res``'s recorded outcomes."""
    accept, duration, prefill, done, chunk = replay_sources(res.trace)
    return ContinuousScheduler(
        SimStepBackend(_model(), capacity=4, accept_source=accept, duration_source=duration,
                       prefill_source=prefill, done_source=done, chunk_source=chunk,
                       **simkw), _ctrl(), policy=PrefillBudgetAdmit(token_budget=16, chunk=8))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunked_admission_outputs_and_parity(engine, paged):
    """Long prompts admitted under a 16-token budget are served across >= 3
    chunks with solo tokens, no iteration's chunk tokens exceed the budget,
    and the sim backend replaying the recorded outcomes reproduces the
    StepTrace, chunk events included."""
    eng, tp, dp, tcfg = engine
    kw = dict(block_size=BLOCK, num_blocks=40) if paged else {}
    backend = ContinuousEngineBackend(eng, tp, dp, capacity=4, cache_len=CACHE_LEN,
                                      collect_outputs=True, warm_s=(2, 3, 4), **kw)
    assert backend.can_chunk
    pol = PrefillBudgetAdmit(token_budget=16, chunk=8)
    res = serve_continuous_live(_trace(tcfg.vocab_size), eng, tp, dp, _ctrl(),
                                backend=backend, policy=pol)
    assert all(r.finish is not None for r in res.requests)
    assert all(r.n_generated == r.max_new for r in res.requests)
    per_rid = Counter(rid for t in res.trace for rid, _ in t.chunked)
    assert per_rid, "no chunk events recorded"
    assert max(per_rid.values()) >= 3            # a prompt spanned >= 3 chunks
    for t in res.trace:
        assert sum(m for _, m in t.chunked) <= pol.token_budget
    for r in res.requests:
        np.testing.assert_array_equal(
            backend.outputs[r.rid], _solo(eng, tp, dp, r.tokens)[:r.n_generated],
            err_msg=f"rid {r.rid} ({per_rid.get(r.rid, 0)} chunks)")
    simkw = dict(block_size=BLOCK, num_blocks=40, max_context=CACHE_LEN) if paged else {}
    sim = _replay(res, **simkw)
    res_sim = sim.run(_trace(tcfg.vocab_size))
    for field in ("admitted", "chunked", "occupancy", "committed", "preempted"):
        assert ([getattr(t, field) for t in sim.trace]
                == [getattr(t, field) for t in res.trace]), field
    np.testing.assert_allclose(res_sim.latencies, res.latencies, rtol=1e-9)


def _pressure_trace(vocab, cls=Request):
    return _trace(vocab, n=8, seed=11, long_every=2, long_len=(28, 40), budget=(18, 25),
                  cls=cls)


def test_chunked_slot_later_preempted(engine):
    """A request admitted chunked is, once live, a normal preemption victim:
    evicted mid-decode from an undersized pool, re-admitted (re-chunked from
    prompt + stash), it still finishes with its solo tokens; the block-mirror
    sim re-derives the same schedule."""
    eng, tp, dp, tcfg = engine
    backend = ContinuousEngineBackend(eng, tp, dp, capacity=4, cache_len=CACHE_LEN,
                                      block_size=BLOCK, num_blocks=22, collect_outputs=True,
                                      warm_s=(2, 3, 4))
    pol = PrefillBudgetAdmit(token_budget=16, chunk=8)
    res = serve_continuous_live(_pressure_trace(tcfg.vocab_size), eng, tp, dp, _ctrl(),
                                backend=backend, policy=pol)
    chunk_rids = {rid for t in res.trace for rid, _ in t.chunked}
    pre_rids = {rid for t in res.trace for rid in t.preempted}
    assert pre_rids, "pool was not under pressure; test lost its bite"
    assert chunk_rids & pre_rids, "no chunk-admitted request was ever preempted"
    assert all(r.finish is not None and r.n_generated == r.max_new for r in res.requests)
    for r in res.requests:
        np.testing.assert_array_equal(
            backend.outputs[r.rid], _solo(eng, tp, dp, r.tokens)[:r.n_generated],
            err_msg=f"rid {r.rid} (preempted={r.rid in pre_rids})")
    sim = _replay(res, block_size=BLOCK, num_blocks=22, max_context=CACHE_LEN)
    res_sim = sim.run(_pressure_trace(tcfg.vocab_size))
    for field in ("admitted", "chunked", "preempted", "occupancy", "committed"):
        assert ([getattr(t, field) for t in sim.trace]
                == [getattr(t, field) for t in res.trace]), field
    np.testing.assert_allclose(res_sim.latencies, res.latencies, rtol=1e-9)


# ---------------------------------------------------------------------------
# against the JAX engine


def test_chunked_live_serving_matches_jax(pair):
    """A paged, undersized pool with chunked admission: the two packages'
    serve_continuous_live give equal admitted, chunked, committed and
    preempted traces and equal tokens per request."""
    je, jt, jd, te, tt, td, tcfg = pair
    geo = dict(capacity=4, cache_len=CACHE_LEN, block_size=BLOCK, num_blocks=22,
               collect_outputs=True, warm_s=(2, 3, 4))
    runs = []
    for eng, tp, dp, cls, backend_cls, serve, policy, ctrl in (
            (je, jt, jd, JRequest, jsched.ContinuousEngineBackend,
             jsched.serve_continuous_live, jsched.PrefillBudgetAdmit, _ctrl(JController, JLUT)),
            (te, tt, td, Request, ContinuousEngineBackend, serve_continuous_live,
             PrefillBudgetAdmit, _ctrl())):
        backend = backend_cls(eng, tp, dp, **geo)
        res = serve(_pressure_trace(tcfg.vocab_size, cls), eng, tp, dp, ctrl,
                    backend=backend, policy=policy(token_budget=16, chunk=8))
        runs.append((res, backend))
    (jres, jbe), (tres, tbe) = runs
    assert any(t.chunked for t in tres.trace) and any(t.preempted for t in tres.trace)
    for field in ("admitted", "chunked", "committed", "preempted"):
        assert ([getattr(t, field) for t in tres.trace]
                == [getattr(t, field) for t in jres.trace]), field
    for r in tres.requests:
        np.testing.assert_array_equal(tbe.outputs[r.rid], np.asarray(jbe.outputs[r.rid]),
                                      err_msg=f"rid {r.rid}")
