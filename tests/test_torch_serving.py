"""The port's host-side serving stack against the JAX package's: the copied
``traffic`` / ``acceptance`` / ``analytical`` / ``adaptive`` / ``metrics``
modules give equal outputs for the same seeds, ``serve()`` over the
simulated backend equals the JAX run batch for batch, the live
``EngineBackend`` returns the JAX engine's tokens on the same weights, and
the launcher runs end to end on the CPU.

These modules are numpy code copied from the JAX package, so outputs must be
equal, not close.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import adaptive as jad
from repro.core import analytical as jan
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models.transformer import DecoderLM as JDecoderLM
from repro.serving import acceptance as jacc
from repro.serving import metrics as jmet
from repro.serving import server as jsrv
from repro.serving import traffic as jtr
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core import adaptive as tad
from repro_torch.core import analytical as tan
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.serving import acceptance as tacc
from repro_torch.serving import metrics as tmet
from repro_torch.serving import server as tsrv
from repro_torch.serving import traffic as ttr
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)


def _model(an):
    """A fitted latency model, built by the given analytical module."""
    verify = {b: {s: 0.01 * b ** 0.5 + 0.002 * s * b for s in range(1, 9)}
              for b in (1, 2, 4, 8, 16)}
    draft = {b: 0.001 + 0.0002 * b for b in (1, 2, 4, 8, 16)}
    runs = [0, 1, 1, 2, 3, 3, 4, 6, 8, 2, 1, 0, 5]
    return an.fit_latency_model(verify, draft, runs)


def _reqs(tr, n=40, seed=5, **kw):
    return tr.uniform_traffic(n, 0.05, 1.5, 512, seed=seed, max_new=24, **kw)


def _same_requests(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.arrival, x.prompt_len, x.max_new, x.start, x.finish) == \
               (y.rid, y.arrival, y.prompt_len, y.max_new, y.start, y.finish)
        np.testing.assert_array_equal(x.tokens, y.tokens)


# ---------------------------------------------------------------------------
# traffic and acceptance


@pytest.mark.parametrize("cv", [0.5, 1.0, 2.0])
def test_gamma_intervals_match_jax(cv):
    a = jtr.gamma_intervals(50, 0.3, cv, np.random.default_rng(1))
    b = ttr.gamma_intervals(50, 0.3, cv, np.random.default_rng(1))
    np.testing.assert_array_equal(b, a)


def test_uniform_and_alternating_traffic_match_jax():
    _same_requests(_reqs(ttr), _reqs(jtr))
    a = jtr.alternating_traffic(60, 512, seed=3, period=2.0, max_new=8)
    b = ttr.alternating_traffic(60, 512, seed=3, period=2.0, max_new=8)
    _same_requests(b, a)


@pytest.mark.parametrize("s", [1, 3, 8])
def test_geometric_acceptance_matches_jax(s):
    ja, ta = jacc.GeometricAcceptance(_model(jan), 4), tacc.GeometricAcceptance(_model(tan), 4)
    assert ta.p(s) == ja.p(s) == tacc.match_prob(_model(tan).l_of_s(s), s)
    for b in (1, 5, 16):
        np.testing.assert_array_equal(ta.draw(b, s), ja.draw(b, s))


# ---------------------------------------------------------------------------
# analytical model and LUT


def test_analytical_fits_match_jax():
    tm, jm = _model(tan), _model(jan)
    assert (tm.c, tm.gamma) == (jm.c, jm.gamma)
    assert tm.alpha == jm.alpha and tm.beta == jm.beta and tm.t_s == jm.t_s
    for b in tm.batch_sizes:
        for s in range(0, 9):
            assert tm.per_token_time(b, s) == jm.per_token_time(b, s)
        assert tm.s_opt(b) == jm.s_opt(b)
        assert tm.delta(b, 2.5) == jm.delta(b, 2.5)
    s_vals, ls = [1, 2, 4, 8], [0.8, 1.3, 2.1, 3.0]
    assert tan.fit_power_law(s_vals, ls) == jan.fit_power_law(s_vals, ls)
    assert tan.power_law_r2(s_vals, ls, 0.8, 0.6) == jan.power_law_r2(s_vals, ls, 0.8, 0.6)
    np.testing.assert_array_equal(tan.acceptance_curve([0, 2, 5], [1, 2, 3]),
                                  jan.acceptance_curve([0, 2, 5], [1, 2, 3]))


def test_roofline_model_matches_jax():
    hw_t, hw_j = tan.HardwareSpec(), jan.HardwareSpec()
    kw = dict(c=0.9, gamma=0.6, cache_bytes_per_seq=1e6)
    t = tan.roofline_latency_model(6.7e9, 1.25e8, hw_t, **kw)
    j = jan.roofline_latency_model(6.7e9, 1.25e8, hw_j, **kw)
    assert (t.alpha, t.beta, t.t_s) == (j.alpha, j.beta, j.t_s)


def test_lut_and_controller_match_jax():
    grid = {1: {0: 5.0, 1: 3.0, 2: 2.5}, 4: {0: 2.0, 1: 1.9, 2: 2.2},
            16: {0: 1.0, 1: 1.2, 2: 1.5}}
    tl, jl = tad.lut_from_grid(grid), jad.lut_from_grid(grid)
    assert dict(tl.table) == dict(jl.table) and tl.is_monotone() == jl.is_monotone()
    for b in range(0, 20):
        assert tl.lookup(max(b, 1)) == jl.lookup(max(b, 1))
    tc = tad.AdaptiveController(lut=tad.lut_from_model(_model(tan)), model=_model(tan))
    jc = jad.AdaptiveController(lut=jad.lut_from_model(_model(jan)), model=_model(jan))
    rng = np.random.default_rng(0)
    for _ in range(30):
        acc = rng.integers(0, 2, 8)
        tc.observe(acc, 4)
        jc.observe(acc, 4)
        assert [tc.choose(b) for b in (0, 1, 3, 8, 16)] == \
               [jc.choose(b) for b in (0, 1, 3, 8, 16)]
    assert tc.refreshes == jc.refreshes > 0
    assert dict(tad.fixed_controller(2).lut.table) == dict(jad.fixed_controller(2).lut.table)


# ---------------------------------------------------------------------------
# the server


@pytest.mark.parametrize("fixed_s", [None, 0, 3])
def test_serve_over_sim_backend_matches_jax(fixed_s):
    def run(an, ad, srv, tr):
        ctl = (ad.AdaptiveController(lut=ad.lut_from_model(_model(an))) if fixed_s is None
               else ad.fixed_controller(fixed_s))
        return srv.serve(_reqs(tr), srv.SimBackend(_model(an), seed=9), ctl, max_batch=8)

    t, j = run(tan, tad, tsrv, ttr), run(jan, jad, jsrv, jtr)
    assert [dataclasses.astuple(b) for b in t.batches] == \
           [dataclasses.astuple(b) for b in j.batches]
    _same_requests(t.requests, j.requests)
    assert dataclasses.astuple(tmet.summarize(t)) == dataclasses.astuple(jmet.summarize(j))
    assert tmet.timeline_groups(t, 7) == jmet.timeline_groups(j, 7)
    assert tmet.batch_size_histogram(t) == jmet.batch_size_histogram(j)
    assert tmet.speedup(t, t) == 1.0


def test_engine_backend_returns_the_jax_engine_tokens():
    jcfg, tcfg = JR.get_smoke_config("opt-6.7b"), TR.get_smoke_config("opt-6.7b")
    jd = jcfg.with_(n_layers=1, name="draft")
    td = tcfg.with_(n_layers=1, name="draft")
    jt = jax.tree.map(np.asarray, JDecoderLM(jcfg).init(jax.random.PRNGKey(0)))
    jdw = jax.tree.map(np.asarray, JDecoderLM(jd).init(jax.random.PRNGKey(1)))
    eng = SpecDecodeEngine(tcfg, td, max_new=6, device="cpu")
    backend = tsrv.EngineBackend(eng, bridge.to_torch(jt, "cpu"),
                                 bridge.to_torch(jdw, "cpu"),
                                 cache_len=64)
    reqs = ttr.uniform_traffic(3, 0.1, 1.0, tcfg.vocab_size, seed=1, max_new=6)
    dt, rec = backend.run_batch(reqs, 2)
    assert dt > 0 and rec.batch_size == 3 and rec.s_used == 2 and rec.n_steps > 0
    # the JAX engine on the batch the backend forms: padded to 4 rows
    B, tp = 4, max(r.prompt_len for r in reqs)
    toks = np.ones((B, tp), np.int32)
    lens = np.full((B,), 4, np.int32)
    for i, r in enumerate(reqs):
        toks[i, :r.prompt_len] = r.tokens
        lens[i] = r.prompt_len
    want, _, _ = JEngine(jcfg, jd, max_new=6).generate(jt, jdw, toks, lens, s=2,
                                                       cache_len=64)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(backend.outputs[r.rid], np.asarray(want)[i])


def test_launcher_smoke_runs_on_cpu():
    res = tlaunch.main(["--smoke", "--device", "cpu", "--dtype", "float32",
                        "--requests", "5", "--max-new", "6", "--profile-bs", "1,2",
                        "--s-max", "2", "--interval", "0.01"])
    assert set(res["lut"]) == {1, 2} and all(0 <= s <= 2 for s in res["lut"].values())
    assert res["adaptive"]["n"] == 5 and res["no_spec"]["n"] == 5
    assert res["tokens_per_s_adaptive"] > 0 and res["device"] == "cpu"
    assert all(t > 0 for d in res["grid_s_per_token"].values() for t in d.values())


def test_engine_and_launcher_default_to_cuda():
    """Entry points run on the card unless the caller names the CPU; without
    CUDA they raise instead of moving to the CPU."""
    cfg = TR.get_smoke_config("opt-6.7b")
    if torch.cuda.is_available():
        assert SpecDecodeEngine(cfg, cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecDecodeEngine(cfg, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--smoke", "--requests", "2"])
