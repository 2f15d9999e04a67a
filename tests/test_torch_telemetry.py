"""The port's telemetry hub (serving/telemetry.py), on the CPU: the eight
tests of ``tests/test_telemetry.py`` on the port (the fragmentation gauge,
a disabled hub is inert, the sim schedule with the hub on, the span
taxonomy and the JSONL log against the StepTrace, the acceptance
observatory, gauges and their expositions, tokens and StepTrace identical
with the hub on and off on the live engine, device annotation restored),
the live identity also on a prefix-cache run with its cache gauges, the
profiler trace of ``profile_dir`` holding the step scopes, and two parity
checks against the JAX hub: the same calls give the same expositions,
summary, acceptance table and JSONL records; and the sim backend on one
trace emits the same stream of spans, iterations and gauges in both
packages, apart from the commit spans' host seconds.

Tolerances: none but in ``test_acceptance_observatory_tracks_process``
(aggregate drift below 0.1, as the JAX test) and the fragmentation gauge
(``pytest.approx``); everything else must be equal.
"""
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import SpeculationLUT as JLUT
from repro.core.analytical import LatencyModel as JLatencyModel
from repro.serving import scheduler as jsched
from repro.serving import telemetry as jtelemetry
from repro.serving.request import Request as JRequest
from repro_torch.configs import registry as R
from repro_torch.core.adaptive import (AdaptiveController, SpeculationLUT,
                                       lut_from_model)
from repro_torch.core.analytical import LatencyModel
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.serving import PHASES, Telemetry
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend,
                                           ContinuousScheduler, PrefillBudgetAdmit,
                                           SimStepBackend, serve_continuous_live)
from repro_torch.serving.server import serve_continuous
from repro_torch.serving.slots import BlockPool
from repro_torch.serving.traffic import TrafficPhase, make_requests, uniform_traffic
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

CACHE_LEN = 96
BLOCK = 8


def _model(batches=(1, 2, 4, 8, 16), cls=LatencyModel):
    return cls(alpha={b: 1e-4 * b ** 0.8 for b in batches},
               beta={b: 5e-3 for b in batches},
               t_s={b: 2e-4 for b in batches}, c=0.9, gamma=0.548)


# ---------------------------------------------------------------------------
# gauges: BlockPool fragmentation


def test_blockpool_fragmentation_gauge():
    pool = BlockPool(8, 4)
    assert pool.fragmentation == 0.0          # fully free: one run
    blocks = pool.alloc(8)                    # lowest-id first: 0..7
    assert pool.fragmentation == 0.0          # nothing free
    pool.free([blocks[0], blocks[2], blocks[4]])   # {0, 2, 4}: all singles
    assert pool.fragmentation == pytest.approx(1 - 1 / 3)
    pool.free([blocks[1]])                    # {0, 1, 2, 4}: best run is 3
    assert pool.fragmentation == pytest.approx(1 - 3 / 4)
    pool.free([blocks[3], blocks[5], blocks[6], blocks[7]])
    assert pool.fragmentation == 0.0          # whole pool contiguous again


# ---------------------------------------------------------------------------
# sim backend: inertness, parity, spans, observatory, expositions


def test_disabled_telemetry_is_inert():
    m = _model()
    tel = Telemetry(enabled=False)
    sched = ContinuousScheduler(
        SimStepBackend(m, capacity=4, seed=0),
        AdaptiveController(lut=lut_from_model(m, s_max=8)), telemetry=tel)
    # the scheduler drops a disabled hub entirely
    assert sched._tel is None
    sched.run(uniform_traffic(20, 0.01, 1.0, 100, seed=4, max_new=8))
    assert tel.events == [] and tel.counters == {}
    assert tel.iterations == 0 and tel.acceptance_table() == []
    tel.span("prefill", 0, 0.1, rid=1)
    tel.observe_step(s=2, batch=2, accepted=[1, 2], duration=0.1)
    tel.iteration(0, 0.0, occupancy=1)
    assert tel.events == [] and tel.counters == {} and tel.gauges == {}


def test_sim_schedule_identical_with_telemetry_on():
    m = _model()

    def go(tel):
        reqs = uniform_traffic(40, 0.01, 2.0, 100, seed=4, max_new=16)
        return serve_continuous(reqs, m, AdaptiveController(lut=lut_from_model(m)),
                                max_batch=8, seed=2, telemetry=tel)

    r0, r1 = go(None), go(Telemetry())
    for f in ("admitted", "occupancy", "committed", "preempted", "chunked"):
        assert [getattr(t, f) for t in r0.trace] == [getattr(t, f) for t in r1.trace], f
    np.testing.assert_allclose(r0.latencies, r1.latencies)


def _sim_requests(cls):
    """Ten requests, long prompts every third, budgets of 8-16 tokens."""
    reqs = make_requests(10, [TrafficPhase(0.01, 1.0, float("inf"))], 100,
                         seed=3, max_new=12)
    rng = np.random.default_rng(0)
    out = []
    for j, r in enumerate(reqs):
        tokens, plen = r.tokens, r.prompt_len
        max_new = int(rng.integers(8, 17))
        if j % 3 == 0:
            plen = int(rng.integers(40, 57))
            tokens = rng.integers(0, 100, (plen,)).astype(np.int32)
        out.append(cls(rid=r.rid, arrival=r.arrival, tokens=tokens, prompt_len=plen,
                       max_new=max_new))
    return out


def _paged_chunked_sim(tel, pkg=None):
    """Paged + chunked sim run sized to preempt (13 blocks of 8 rows across
    4 slots); ``pkg=jsched`` runs the JAX package's scheduler."""
    jax_side = pkg is not None
    mod = pkg if jax_side else None
    ctrl = (JController(lut=JLUT({1: 4, 2: 3, 4: 2})) if jax_side
            else AdaptiveController(lut=SpeculationLUT({1: 4, 2: 3, 4: 2})))
    sim = (mod.SimStepBackend if jax_side else SimStepBackend)(
        _model(cls=JLatencyModel if jax_side else LatencyModel), capacity=4, seed=1,
        block_size=BLOCK, num_blocks=13, max_context=96)
    policy = (mod.PrefillBudgetAdmit if jax_side else PrefillBudgetAdmit)(token_budget=16,
                                                                          chunk=8)
    sched = (mod.ContinuousScheduler if jax_side else ContinuousScheduler)(
        sim, ctrl, policy=policy, telemetry=tel)
    res = sched.run(_sim_requests(JRequest if jax_side else Request))
    res.trace = sched.trace
    return res


def test_span_taxonomy_counters_and_jsonl(tmp_path):
    path = tmp_path / "events.jsonl"
    tel = Telemetry(jsonl_path=str(path))
    res = _paged_chunked_sim(tel)
    tel.close()
    trace = res.trace
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines, "no events streamed"
    spans = [e for e in lines if e["ev"] == "span"]
    assert {e["phase"] for e in spans} <= set(PHASES)
    assert tel.counters["chunk_continue"] == sum(len(t.chunked) for t in trace)
    assert tel.counters["preempt"] == sum(len(t.preempted) for t in trace)
    assert tel.counters["preempt"] > 0, "geometry lost its preemption bite"
    assert tel.counters["decode_verify"] == sum(1 for t in trace if t.occupancy > 0)
    assert tel.counters["retire"] == len(res.requests)
    assert tel.counters["admit"] == sum(1 for t in trace if t.admitted)
    assert tel.counters.get("prefill", 0) == sum(
        1 for t in trace for dt in t.prefill_s if dt >= 0)
    assert len(tel.events) == len(lines)
    assert tel.tokens_committed == sum(r.n_generated for r in res.requests)
    chunk_dt = sum(e["dt"] for e in spans if e["phase"] == "chunk_continue")
    assert chunk_dt == pytest.approx(sum(sum(t.chunk_s) for t in trace))


def test_acceptance_observatory_tracks_process():
    m = _model()
    tel = Telemetry()
    tel.attach_expected_acceptance(lambda s: m.l_of_s(s) / s)
    reqs = uniform_traffic(60, 0.005, 1.0, 100, seed=6, max_new=24)
    res = serve_continuous(reqs, m, AdaptiveController(lut=lut_from_model(m)),
                           max_batch=8, seed=1, telemetry=tel)
    table = tel.acceptance_table()
    assert table
    assert sum(row["draws"] for row in table) == sum(
        t.occupancy for t in res.trace if t.occupancy > 0 and t.s > 0)
    for row in table:
        assert sum(row["hist"]) == row["draws"]
        assert 0.0 <= row["acceptance"] <= 1.0
        assert row["expected"] is not None
    drift = tel.acceptance_drift()
    assert drift is not None and abs(drift) < 0.1


def test_controller_model_is_the_drift_baseline():
    """A controller that carries the analytical model wires it into the
    hub's observatory, as the JAX scheduler does."""
    m = _model()
    tel = Telemetry()
    ContinuousScheduler(SimStepBackend(m, capacity=4, seed=0),
                        AdaptiveController(lut=lut_from_model(m), model=m), telemetry=tel)
    assert tel.expected_acceptance(3) == pytest.approx(m.l_of_s(3) / 3)


def test_gauges_prometheus_and_dashboard():
    stream = io.StringIO()
    tel = Telemetry(dashboard_every=4, stream=stream)
    _paged_chunked_sim(tel)
    g = tel.gauges
    assert g["occupancy"] == 0 and g["backlog"] == 0
    assert g["free_blocks"] == 13 and g["used_blocks"] == 0
    assert 0.0 <= g["fragmentation"] <= 1.0
    assert tel.peaks["occupancy"] >= 2
    assert tel.peaks["used_blocks"] > 0
    text = tel.prometheus_text()
    assert "repro_serving_occupancy 0" in text
    assert 'repro_serving_spans_total{phase="decode_verify"}' in text
    assert "repro_serving_acceptance_observed{" in text
    assert "repro_serving_peak_occupancy" in text
    dash = tel.dashboard()
    assert "backlog" in dash and "blocks" in dash
    assert stream.getvalue(), "periodic dashboard never printed"
    summ = tel.summary()
    assert summ["counters"] == tel.counters
    assert summ["tokens_committed"] == tel.tokens_committed


# ---------------------------------------------------------------------------
# parity with the JAX hub


def _drive(tel):
    """One fixed sequence of every recording call."""
    tel.attach_expected_acceptance(lambda s: 0.8 - 0.05 * s)
    for it in range(6):
        tel.span("admit", it, 0.01 * it, rids=(it,), n_chunked=0)
        tel.span("prefill", it, 0.002, rid=it, slot=it % 4, tokens=17 + it)
        tel.span("decode_verify", it, 0.004 + 1e-4 * it, s=1 + it % 3, batch=1 + it % 4)
        tel.span("commit", it, 1e-5, tokens=3 + it, batch=1 + it % 4, retired=it % 2)
        tel.observe_step(s=1 + it % 3, batch=1 + it % 4,
                         accepted=[(it + k) % (2 + it % 3) for k in range(1 + it % 4)],
                         duration=0.004 + 1e-4 * it)
        if it % 2:
            tel.span("retire", it, 0.0, rid=it, slot=0, n_generated=9)
            tel.span("preempt", it, 0.0, rid=it + 10, slot=1, n_generated=2)
        tel.iteration(it, 0.1 * it, occupancy=it % 4, decode_batch=1 + it % 4,
                      s=1 + it % 3, prefilling=0, backlog=6 - it, free_slots=4 - it % 4,
                      capacity=4, free_blocks=10 - it, used_blocks=it,
                      fragmentation=0.1 * (it % 3), grid_occupancy=0.5)


def test_hub_matches_jax(tmp_path):
    ours = Telemetry(jsonl_path=str(tmp_path / "port.jsonl"))
    theirs = jtelemetry.Telemetry(jsonl_path=str(tmp_path / "jax.jsonl"))
    assert PHASES == jtelemetry.PHASES
    for tel in (ours, theirs):
        _drive(tel)
        tel.close()
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.summary() == theirs.summary()
    assert ours.acceptance_table() == theirs.acceptance_table()
    assert ours.dashboard() == theirs.dashboard()
    assert ((tmp_path / "port.jsonl").read_text().splitlines()
            == (tmp_path / "jax.jsonl").read_text().splitlines())


def _stream(tel):
    """The event stream without the host seconds of the commit spans."""
    return [{k: v for k, v in e.items() if not (e.get("phase") == "commit" and k == "dt")}
            for e in tel.events]


def test_sim_event_stream_matches_jax():
    ours, theirs = Telemetry(), jtelemetry.Telemetry()
    r0 = _paged_chunked_sim(ours)
    r1 = _paged_chunked_sim(theirs, pkg=jsched)
    assert len(r0.trace) == len(r1.trace)
    assert ours.counters == theirs.counters and ours.counters["preempt"] > 0
    assert _stream(ours) == _stream(theirs)
    assert ours.acceptance_table() == [
        dict(row, mean_step_s=pytest.approx(row["mean_step_s"]))
        for row in theirs.acceptance_table()]


# ---------------------------------------------------------------------------
# live engine: token + StepTrace identity with telemetry on vs off


@pytest.fixture(scope="module")
def engine():
    tcfg = R.get_smoke_config("yi-9b")
    d = R.get_draft_config("yi-9b")
    dcfg = dataclasses.replace(
        d, n_layers=1, d_model=64, d_ff=128, vocab_size=tcfg.vocab_size,
        attn=dataclasses.replace(d.attn, n_heads=2, n_kv_heads=2, head_dim=32))
    eng = SpecDecodeEngine(tcfg, dcfg, max_new=24, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tp, dp = eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu")
    return eng, tp, dp, tcfg


def _ctrl():
    return AdaptiveController(lut=SpeculationLUT({1: 4, 2: 3, 4: 2}))


def _live_trace(tcfg, n=8, seed=7, long_every=0, budget=(4, 17), shared=0):
    reqs = make_requests(n, [TrafficPhase(0.002, 1.0, float("inf"))],
                         tcfg.vocab_size, seed=seed, max_new=16)
    rng = np.random.default_rng(3)
    system = rng.integers(0, tcfg.vocab_size, (shared,)).astype(np.int32)
    for j, r in enumerate(reqs):
        # arrivals at 0: the live clock advances by measured wall times, so
        # the on-against-off identity must not hang on them
        r.arrival = 0.0
        r.max_new = int(rng.integers(*budget))
        if long_every and j % long_every == 0:
            L = int(rng.integers(28, 40))
            r.tokens = rng.integers(0, tcfg.vocab_size, (L,)).astype(np.int32)
            r.prompt_len = L
        if shared:
            r.tokens = np.concatenate([system, r.tokens[:r.prompt_len]])
            r.prompt_len = len(r.tokens)
    return reqs


LIVE_CASES = {
    "contiguous": dict(trace={}, backend={}, chunked_policy=False),
    "paged_preempt": dict(trace=dict(budget=(18, 25)),
                          backend=dict(block_size=BLOCK, num_blocks=18),
                          chunked_policy=False),
    "chunked": dict(trace=dict(long_every=3),
                    backend=dict(block_size=BLOCK, num_blocks=40),
                    chunked_policy=True),
    "prefix_cache": dict(trace=dict(shared=16, budget=(4, 9)),
                         backend=dict(block_size=BLOCK, num_blocks=48, prefix_cache=True),
                         chunked_policy=False),
}


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_live_token_and_trace_identity_with_telemetry(engine, case, tmp_path):
    cfg = LIVE_CASES[case]
    eng, tp, dp, tcfg = engine

    def go(tel):
        be = ContinuousEngineBackend(eng, tp, dp, capacity=4, cache_len=CACHE_LEN,
                                     warm_s=(2, 3, 4), collect_outputs=True,
                                     **cfg["backend"])
        pol = PrefillBudgetAdmit(token_budget=16, chunk=8) if cfg["chunked_policy"] else None
        res = serve_continuous_live(_live_trace(tcfg, **cfg["trace"]), eng, tp, dp, _ctrl(),
                                    backend=be, policy=pol, telemetry=tel)
        return res, be

    tel = Telemetry(jsonl_path=str(tmp_path / f"{case}.jsonl"))
    (r0, b0), (r1, b1) = go(None), go(tel)
    tel.close()
    for f in ("admitted", "occupancy", "committed", "preempted", "done_rids", "chunked",
              "cache_hits"):
        assert [getattr(t, f) for t in r0.trace] == [getattr(t, f) for t in r1.trace], f
    assert set(b0.outputs) == set(b1.outputs)
    for rid in b0.outputs:
        np.testing.assert_array_equal(b0.outputs[rid], b1.outputs[rid],
                                      err_msg=f"{case} rid {rid}")
    if case == "paged_preempt":
        assert tel.counters["preempt"] > 0
        assert sum(len(t.preempted) for t in r1.trace) > 0
    if case == "chunked":
        assert tel.counters["chunk_continue"] > 0
        assert sum(len(t.chunked) for t in r1.trace) > 0
    if case == "prefix_cache":
        hits = [h for t in r1.trace for h in t.cache_hits]
        assert len(hits) >= 4
        g = tel.gauges
        assert g["cache_hit_tokens"] == b1.cache.hit_tokens == sum(p for _, p in hits)
        assert g["cache_hit_rate"] == pytest.approx(b1.cache.hits / b1.cache.lookups)
        assert g["cached_blocks"] == b1.kv.cached_blocks > 0
        assert g["shared_blocks"] == b1.kv.shared_blocks
        assert g["evicted_blocks"] == b1.kv.evicted_total
        assert tel.peaks["used_blocks"] > 0
    assert tel.counters["retire"] == len(r1.requests)
    assert tel.tokens_committed == sum(r.n_generated for r in r1.requests)


def test_device_annotation_scopes_run_and_reset(engine):
    """``annotate_device=True`` runs every dispatch inside a
    ``record_function`` scope, and the engine flag is restored after."""
    eng, tp, dp, tcfg = engine
    assert eng.annotate is False
    tel = Telemetry(annotate_device=True)
    res = serve_continuous_live(_live_trace(tcfg, n=4), eng, tp, dp, _ctrl(), capacity=2,
                                cache_len=CACHE_LEN, telemetry=tel)
    assert all(r.finish is not None for r in res.requests)
    assert tel.iterations == len(res.trace)
    assert eng.annotate is False


def test_profile_dir_trace_holds_the_scopes(engine, tmp_path):
    """``profile_dir``: a ``torch.profiler`` trace around the run, exported
    as a Chrome trace, with the engine's step, prefill and retire scopes."""
    eng, tp, dp, tcfg = engine
    tel = Telemetry(profile_dir=str(tmp_path / "prof"))
    serve_continuous_live(_live_trace(tcfg, n=3), eng, tp, dp, _ctrl(), capacity=2,
                          cache_len=CACHE_LEN, block_size=BLOCK, telemetry=tel)
    assert eng.annotate is False and tel.trace_path is not None
    names = {e["name"] for e in json.loads(open(tel.trace_path).read())["traceEvents"]
             if "name" in e}
    for scope in ("repro/step[B=2,s=", "repro/prefill[B=1,P=", "repro/inject",
                  "repro/retire"):
        assert any(n.startswith(scope) for n in names), scope
