"""The port's live continuous-batching runtime on the CPU: the slot pool of
``SpecDecodeEngine`` (contiguous and paged), ``ContinuousEngineBackend``,
``ContinuousScheduler`` and ``serve_continuous_live``, as ports of the tests
of ``tests/test_paged_kv.py``, plus cross-package checks: JAX's
``serve_continuous_live`` and the port's, on the same bridged weights and
trace, give identical tokens per request and an identical StepTrace
signature, and the simulated ``serve_continuous`` gives an identical trace.

Tokens must be equal, not close: both engines take the argmax of fp32
logits that agree to about 1e-6, and the trace's scheduling decisions are
functions of token counts and block accounting only.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import SpeculationLUT as JLUT
from repro.core.analytical import LatencyModel as JLatencyModel
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.serving import scheduler as jsched
from repro.serving import metrics as jmetrics
from repro.serving import server as jserver
from repro.serving.request import Request as JRequest
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core.adaptive import AdaptiveController, SpeculationLUT
from repro_torch.core.analytical import LatencyModel
from repro_torch.core.spec_decode import S_MAX, SpecDecodeEngine
from repro_torch.serving import metrics
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend,
                                           ContinuousScheduler,
                                           PrefillBudgetAdmit, SimStepBackend,
                                           replay_sources,
                                           serve_continuous_live)
from repro_torch.serving.server import serve_continuous
from repro_torch.serving.traffic import TrafficPhase, make_requests
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

CACHE_LEN = 96
BLOCK = 8


def _draft(registry, tcfg):
    d = registry.get_draft_config("yi-9b")
    return dataclasses.replace(
        d, n_layers=1, d_model=64, d_ff=128, vocab_size=tcfg.vocab_size,
        attn=dataclasses.replace(d.attn, n_heads=2, n_kv_heads=2, head_dim=32))


@pytest.fixture(scope="module")
def engine():
    tcfg = R.get_smoke_config("yi-9b")
    eng = SpecDecodeEngine(tcfg, _draft(R, tcfg), max_new=24, device="cpu")
    gen = torch.Generator().manual_seed(0)
    return (eng, eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu"),
            tcfg)


def _ctrl(cls=AdaptiveController, lut=SpeculationLUT):
    return cls(lut=lut({1: 4, 2: 3, 4: 2}))


def _trace(vocab, n=12, seed=7, budget=(4, 17), cls=Request):
    """Rapid-arrival trace; ``budget=(18, 25)`` makes requests outgrow the
    admission-time reservation so that block pressure (preemption) arises
    mid-flight."""
    reqs = make_requests(n, [TrafficPhase(0.0005, 1.0, float("inf"))], vocab,
                         seed=seed, max_new=16)
    rng = np.random.default_rng(3)
    out = []
    for r in reqs:
        out.append(cls(rid=r.rid, arrival=r.arrival, tokens=r.tokens,
                       prompt_len=r.prompt_len, max_new=int(rng.integers(*budget))))
    return out


def _solo(eng, tp, dp, prompt):
    out, _, _ = eng.generate(tp, dp, np.asarray(prompt)[None, :],
                             np.array([len(prompt)], np.int32), s=3, cache_len=CACHE_LEN)
    return out[0]


def _signature(trace):
    return [(t.occupancy, t.s, tuple(t.rids), dict(t.committed), tuple(t.admitted),
             tuple(t.preempted), tuple(t.done_rids)) for t in trace]


# ---------------------------------------------------------------------------
# the engine's slot pool


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_slot_pool_matches_solo_generate(engine, paged):
    """Tokens generated through the slot pool — including a request
    injected mid-flight and a slot reusing a retired row — equal each
    prompt's solo output."""
    eng, tp, dp, tcfg = engine
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, (L,)).astype(np.int32) for L in (8, 6, 9)]
    refs = [_solo(eng, tp, dp, p) for p in prompts]
    state = eng.init_slots(4, CACHE_LEN, block_size=BLOCK if paged else None)
    assert (state.paged is not None) == paged
    if paged:
        assert state.paged.num_blocks == 4 * (CACHE_LEN // BLOCK)
    assert bool(state.done.all())
    for slot in (0, 1):
        state = eng.prefill_into(tp, dp, state, slot, prompts[slot], len(prompts[slot]),
                                 CACHE_LEN)
    for _ in range(2):
        state, st = eng.step(tp, dp, state, 3)
        assert (st.committed[2:] == 0).all()       # empty slots stay silent
    state = eng.prefill_into(tp, dp, state, 2, prompts[2], len(prompts[2]), CACHE_LEN)
    for _ in range(40):
        state, _ = eng.step(tp, dp, state, 3)
        if bool(state.done[:3].all()):
            break
    out = state.out.numpy()[:, :eng.max_new]
    for i in range(3):
        np.testing.assert_array_equal(out[i], refs[i], err_msg=f"slot {i}")
    free_before = state.paged.free_blocks if paged else None
    state = eng.retire_slot(state, 0)
    if paged:
        assert state.paged.free_blocks > free_before
        assert (state.tcache["bt"][0] == -1).all()
    p = rng.integers(0, tcfg.vocab_size, (7,)).astype(np.int32)
    state = eng.prefill_into(tp, dp, state, 0, p, 7, CACHE_LEN)
    for _ in range(40):
        state, _ = eng.step(tp, dp, state, 3)
        if bool(state.done[0]):
            break
    np.testing.assert_array_equal(state.out.numpy()[0, :eng.max_new], _solo(eng, tp, dp, p))


def test_paged_allocation_is_block_granular(engine):
    eng, tp, dp, tcfg = engine
    state = eng.init_slots(2, CACHE_LEN, block_size=BLOCK)
    p = np.arange(6, dtype=np.int32) % tcfg.vocab_size + 1
    state = eng.prefill_into(tp, dp, state, 0, p, 6, CACHE_LEN)
    pk = state.paged
    assert pk.allocated(0) == 1                    # 6 tokens -> 1 block of 8
    state, st = eng.step(tp, dp, state, 3)
    assert pk.allocated(0) == 2                    # seq + s = 9 rows
    assert pk.allocated(1) == 0
    np.testing.assert_array_equal(state.tcache["bt"].numpy(), pk.device_tables())
    assert st.committed[0] >= 1                    # the host mirror advanced
    assert pk.tokens(0) == 6 + st.committed[0]


def test_warm_calls_leave_the_state_untouched(engine):
    eng, tp, dp, tcfg = engine
    state = eng.init_slots(2, CACHE_LEN, block_size=BLOCK)
    p = np.arange(9, dtype=np.int32) + 1
    state = eng.prefill_into(tp, dp, state, 0, p, 9, CACHE_LEN)
    before = (copy.deepcopy(state.tcache), state.seq_lens.clone(),
              state.paged.device_tables().copy(), state.paged.free_blocks)
    state = eng.prefill_into(tp, dp, state, 1, p, 9, CACHE_LEN, warm=True)
    state, st = eng.step(tp, dp, state, 3, warm=True)
    assert (st.committed == 0).all()
    assert all(torch.equal(state.tcache[n], before[0][n]) for n in before[0])
    assert torch.equal(state.seq_lens, before[1])
    np.testing.assert_array_equal(state.paged.device_tables(), before[2])
    assert state.paged.free_blocks == before[3]


def test_step_rejects_s_beyond_smax(engine):
    eng, tp, dp, tcfg = engine
    state = eng.init_slots(2, CACHE_LEN, block_size=BLOCK)
    with pytest.raises(ValueError, match="S_MAX"):
        eng.step(tp, dp, state, S_MAX + 1)
    with pytest.raises(ValueError):
        eng.step(tp, dp, state, -1)


# ---------------------------------------------------------------------------
# the scheduler on the live engine


def test_preemption_completes_and_outputs_match_solo(engine):
    """An undersized block pool forces preemption; every request still
    finishes with its full budget, and every output — including requests
    evicted and re-prefilled — equals the solo greedy continuation."""
    eng, tp, dp, tcfg = engine
    backend = ContinuousEngineBackend(eng, tp, dp, capacity=4, cache_len=CACHE_LEN,
                                      block_size=BLOCK, num_blocks=18,
                                      collect_outputs=True, warm_s=(2, 3, 4))
    res = serve_continuous_live(_trace(tcfg.vocab_size, budget=(18, 25)), eng, tp, dp,
                                _ctrl(), backend=backend)
    preempted = {rid for t in res.trace for rid in t.preempted}
    assert preempted, "pool was not under pressure; test lost its bite"
    assert all(r.finish is not None and r.n_generated == r.max_new for r in res.requests)
    for r in res.requests:
        np.testing.assert_array_equal(
            backend.outputs[r.rid], _solo(eng, tp, dp, r.tokens)[:r.n_generated],
            err_msg=f"rid {r.rid} (preempted={r.rid in preempted})")
    assert metrics.ttft_summary(res).n == len(res.requests)
    assert metrics.goodput(res) > 0


def test_preemption_sim_vs_live_parity(engine):
    """The sim backend with the live pool's block geometry re-derives the
    identical preemption schedule when replaying the live run's outcomes."""
    eng, tp, dp, tcfg = engine
    res = serve_continuous_live(_trace(tcfg.vocab_size, budget=(18, 25)), eng, tp, dp,
                                _ctrl(), capacity=4, cache_len=CACHE_LEN,
                                block_size=BLOCK, num_blocks=18)
    assert sum(len(t.preempted) for t in res.trace) > 0
    accept, duration, prefill, done, _chunk = replay_sources(res.trace)
    bs = (1, 2, 4)
    model = LatencyModel(alpha={b: 1e-4 for b in bs}, beta={b: 5e-3 for b in bs},
                         t_s={b: 2e-4 for b in bs}, c=0.9, gamma=0.548)
    sim = ContinuousScheduler(
        SimStepBackend(model, capacity=4, accept_source=accept, duration_source=duration,
                       prefill_source=prefill, done_source=done, block_size=BLOCK,
                       num_blocks=18, max_context=CACHE_LEN), _ctrl())
    res_sim = sim.run(_trace(tcfg.vocab_size, budget=(18, 25)))
    assert _signature(sim.trace) == _signature(res.trace)
    np.testing.assert_allclose(res_sim.latencies, res.latencies, rtol=1e-9)


def test_output_for_truncates_to_request_budget(engine):
    eng, tp, dp, tcfg = engine
    reqs = _trace(tcfg.vocab_size, n=3)
    for r in reqs:
        r.max_new = 5
    backend = ContinuousEngineBackend(eng, tp, dp, capacity=2, cache_len=CACHE_LEN,
                                      collect_outputs=True, warm_s=(2, 3))
    res = serve_continuous_live(reqs, eng, tp, dp, _ctrl(), backend=backend)
    for r in res.requests:
        assert r.n_generated == 5 and backend.outputs[r.rid].shape == (5,)
        np.testing.assert_array_equal(backend.outputs[r.rid], _solo(eng, tp, dp, r.tokens)[:5])


@pytest.mark.parametrize("block_size", [None, BLOCK], ids=["contiguous", "paged"])
def test_admission_rejects_kv_overflow(engine, block_size):
    eng, tp, dp, tcfg = engine
    big = _trace(tcfg.vocab_size, n=2)
    big[0] = Request(rid=99, arrival=0.0, tokens=np.ones(CACHE_LEN - 10, np.int32),
                     prompt_len=CACHE_LEN - 10, max_new=20)
    with pytest.raises(ValueError, match="KV"):
        serve_continuous_live(big, eng, tp, dp, _ctrl(), capacity=2, cache_len=CACHE_LEN,
                              block_size=block_size)


@pytest.mark.parametrize("kw,item", [({"prefix_cache": True}, "item 10"),
                                     ({"mesh": object()}, "item 14"),
                                     ({"telemetry": object()}, "item 11")])
def test_unported_features_raise(engine, kw, item):
    eng, tp, dp, tcfg = engine
    with pytest.raises(NotImplementedError, match=item):
        serve_continuous_live(_trace(tcfg.vocab_size, n=2), eng, tp, dp, _ctrl(),
                              capacity=2, cache_len=CACHE_LEN, block_size=BLOCK, **kw)


def test_budget_policy_falls_back_to_whole_prompts_on_the_engine():
    """A Mamba-2 target has no chunked prefill, so the live backend cannot
    chunk and a PrefillBudgetAdmit policy budgets whole prompts (as JAX does
    on a chunk-incapable backend); the engine refuses a chunk."""
    tcfg = R.get_smoke_config("mamba2-1.3b")
    d = R.get_draft_config("mamba2-1.3b")
    dcfg = dataclasses.replace(
        d, n_layers=1, d_model=64, d_ff=128, vocab_size=tcfg.vocab_size,
        attn=dataclasses.replace(d.attn, n_heads=2, n_kv_heads=2, head_dim=32))
    eng = SpecDecodeEngine(tcfg, dcfg, max_new=24, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tp, dp = eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu")
    backend = ContinuousEngineBackend(eng, tp, dp, capacity=3, cache_len=CACHE_LEN,
                                      collect_outputs=True)
    assert not backend.can_chunk
    with pytest.raises(NotImplementedError, match="family 'ssm'"):
        eng.prefill_chunk_into(tp, dp, backend.state, 0, np.ones((8,), np.int32), 0, 8, 20)
    res = serve_continuous_live(_trace(tcfg.vocab_size, n=6), eng, tp, dp, _ctrl(),
                                policy=PrefillBudgetAdmit(token_budget=24, chunk=8),
                                backend=backend)
    assert not any(t.chunked for t in res.trace)
    assert all(r.finish is not None for r in res.requests)


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.fixture(scope="module")
def pair():
    """JAX and port engines on the same JAX-initialised weights."""
    jcfg, tcfg = JR.get_smoke_config("yi-9b"), R.get_smoke_config("yi-9b")
    je = JEngine(jcfg, _draft(JR, jcfg), max_new=24)
    te = SpecDecodeEngine(tcfg, _draft(R, tcfg), max_new=24, device="cpu")
    jt = jax.tree.map(np.asarray, je.target.init(jax.random.PRNGKey(0)))
    jd = jax.tree.map(np.asarray, je.draft.init(jax.random.PRNGKey(1)))
    return je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"), tcfg


def test_live_serving_matches_jax(pair):
    """Arrivals at 0, a paged and undersized pool: the two packages'
    serve_continuous_live give identical tokens per request and an
    identical StepTrace signature, preemptions included."""
    je, jt, jd, te, tt, td, tcfg = pair
    geo = dict(capacity=4, cache_len=CACHE_LEN, block_size=BLOCK, num_blocks=18,
               collect_outputs=True, warm_s=(2, 3, 4))
    runs = []
    for eng, tp, dp, cls, backend_cls, serve, ctrl in (
            (je, jt, jd, JRequest, jsched.ContinuousEngineBackend,
             jsched.serve_continuous_live, _ctrl(JController, JLUT)),
            (te, tt, td, Request, ContinuousEngineBackend, serve_continuous_live, _ctrl())):
        reqs = _trace(tcfg.vocab_size, budget=(18, 25), cls=cls)
        for r in reqs:
            r.arrival = 0.0
        backend = backend_cls(eng, tp, dp, **geo)
        runs.append((serve(reqs, eng, tp, dp, ctrl, backend=backend), backend))
    (jres, jbe), (tres, tbe) = runs
    assert sum(len(t.preempted) for t in tres.trace) > 0
    assert _signature(tres.trace) == _signature(jres.trace)
    for r in tres.requests:
        np.testing.assert_array_equal(tbe.outputs[r.rid], np.asarray(jbe.outputs[r.rid]),
                                      err_msg=f"rid {r.rid}")


@pytest.mark.parametrize("variant", ["immediate", "chunked_paged"])
def test_simulated_serving_matches_jax(variant):
    """The scheduler over the fitted model: the same trace in both packages
    (scheduling, acceptance draws and clock are all host numpy).
    ``chunked_paged`` runs the budgeted chunked admission and preemption on
    a paged sim mirror (the live engine's chunked runs are held against
    JAX's in ``test_torch_chunked_prefill.py``)."""
    bs = (1, 2, 4, 8)
    kw = dict(alpha={b: 1e-4 * b for b in bs}, beta={b: 5e-3 for b in bs},
              t_s={b: 2e-4 for b in bs}, c=0.9, gamma=0.548)
    results = []
    for model, ctrl, cls, pkg, srv, P in (
            (LatencyModel(**kw), _ctrl(), Request, None, serve_continuous,
             PrefillBudgetAdmit),
            (JLatencyModel(**kw), _ctrl(JController, JLUT), JRequest, jsched,
             jserver.serve_continuous, jsched.PrefillBudgetAdmit)):
        reqs = _trace(512, n=20, budget=(18, 25), cls=cls)
        if variant == "immediate":
            results.append(srv(reqs, model, ctrl, max_batch=4, seed=5))
            continue
        Sched, Sim = ((ContinuousScheduler, SimStepBackend) if pkg is None
                      else (pkg.ContinuousScheduler, pkg.SimStepBackend))
        sched = Sched(Sim(model, capacity=4, seed=5, block_size=BLOCK, num_blocks=18,
                          max_context=CACHE_LEN, prefill_token_cost=1e-4),
                      ctrl, P(token_budget=16, chunk=8))
        res = sched.run(reqs)
        res.trace = sched.trace
        results.append(res)
    tres, jres = results
    assert _signature(tres.trace) == _signature(jres.trace)
    assert [t.chunked for t in tres.trace] == [t.chunked for t in jres.trace]
    assert [t.clock for t in tres.trace] == [t.clock for t in jres.trace]
    np.testing.assert_array_equal(tres.latencies, jres.latencies)
    if variant == "chunked_paged":
        assert any(t.chunked for t in tres.trace) and any(t.preempted for t in tres.trace)
        assert metrics.admission_gaps(tres) == jmetrics.admission_gaps(jres)
