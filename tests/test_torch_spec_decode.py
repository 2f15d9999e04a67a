"""The port's speculative-decoding engine: the golden invariant (speculative
tokens equal greedy tokens for any s and any draft), token and per-step
``StepStats`` equality with the JAX ``SpecDecodeEngine`` on the same
weights, and the EOS / max_new semantics of ``tests/test_spec_decode.py``.

Weights and prompts are made with numpy from a seed and handed to both
packages.  Three drafts cover the acceptance paths: a small random draft
(nothing accepted), the target itself (everything accepted) and the target
with noise added to its weights (part accepted).  Tokens must be equal,
not close: both engines take the argmax of fp32 logits that agree to 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core.spec_decode import S_MAX, SpecDecodeEngine
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = ["opt-6.7b", "yi-9b"]


def _small_draft(registry, cfg):
    base = registry.get_draft_config(cfg.name.replace("-smoke", ""))
    return dataclasses.replace(
        base, n_layers=1, d_model=64, d_ff=128, vocab_size=cfg.vocab_size,
        attn=dataclasses.replace(base.attn, n_heads=2, n_kv_heads=2, head_dim=32))


def _weights(arch, draft):
    """numpy weights for (target, draft) built by the JAX init."""
    jcfg = JR.get_smoke_config(arch)
    jt = jax.tree.map(np.asarray, JDecoderLM(jcfg).init(jax.random.PRNGKey(0)))
    if draft == "small":
        jd = jax.tree.map(np.asarray, JDecoderLM(_small_draft(JR, jcfg)).init(
            jax.random.PRNGKey(1)))
    elif draft == "same":
        jd = jt
    else:   # "noisy": part of the drafts are accepted
        rng = np.random.default_rng(1)
        jd = jax.tree.map(lambda a: (a + 0.1 * a.std() * rng.standard_normal(a.shape)
                                     ).astype(np.float32), jt)
    return jt, jd


def _engines(arch, draft, max_new=12):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jdc = _small_draft(JR, jcfg) if draft == "small" else jcfg
    tdc = _small_draft(TR, tcfg) if draft == "small" else tcfg
    je = JEngine(jcfg, jdc, max_new=max_new)
    te = SpecDecodeEngine(tcfg, tdc, max_new=max_new, device="cpu")
    jt, jd = _weights(arch, draft)
    return (je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"),
            tcfg)


def _prompts(vocab, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (3, 10)).astype(np.int32)
    return toks, np.array([10, 7, 9], np.int32)


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_equals_greedy(arch, s):
    tcfg = TR.get_smoke_config(arch)
    eng = SpecDecodeEngine(tcfg, _small_draft(TR, tcfg), max_new=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tp, dp = eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu")
    toks, lens = _prompts(tcfg.vocab_size)
    ref, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=96)
    out, _, _ = eng.generate(tp, dp, toks, lens, s=s, cache_len=96)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("draft,s", [("small", 0), ("small", 3), ("same", 2),
                                     ("same", 4), ("noisy", 1), ("noisy", 3)])
def test_tokens_and_stats_match_jax(draft, s):
    je, jt, jd, te, tt, td, tcfg = _engines("yi-9b", draft)
    toks, lens = _prompts(tcfg.vocab_size)
    jout, jstats, jn = je.generate(jt, jd, toks, lens, s=s, cache_len=64,
                                   collect_stats=True)
    tout, tstats, tn = te.generate(tt, td, toks, lens, s=s, cache_len=64,
                                   collect_stats=True)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    assert tn == jn and len(tstats) == len(jstats)
    for a, b in zip(tstats, jstats):
        np.testing.assert_array_equal(a.accepted, b.accepted)
        np.testing.assert_array_equal(a.committed, b.committed)
    accepted = sum(int(st.accepted.sum()) for st in tstats)
    if draft == "same" or (draft == "noisy" and s > 1):
        assert accepted > 0      # the accept path really ran


def test_full_acceptance_with_the_target_as_draft():
    je, jt, jd, te, tt, td, tcfg = _engines("opt-6.7b", "same", max_new=12)
    toks, lens = _prompts(tcfg.vocab_size)
    _, stats, n = te.generate(tt, td, toks, lens, s=3, cache_len=64, collect_stats=True)
    assert n == 3 and all((st.accepted == 3).all() for st in stats)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_acceptance_bounds_and_progress(s):
    """0 <= accepted <= s and committed == accepted + 1 while not done."""
    je, jt, jd, te, tt, td, tcfg = _engines("yi-9b", "noisy", max_new=12)
    toks, lens = _prompts(tcfg.vocab_size, seed=0)
    state = te.prefill(tt, td, toks, lens, cache_len=96)
    for _ in range(4):
        prev_done = state.done.numpy().copy()
        state, st = te.step(tt, td, state, s)
        assert (st.accepted >= 0).all() and (st.accepted <= s).all()
        live = ~prev_done
        np.testing.assert_array_equal(st.committed[live],
                                      np.minimum(st.accepted[live] + 1, 12))
        assert (st.committed[prev_done] == 0).all()


def _small_engine(max_new, seed=0):
    tcfg = TR.get_smoke_config("yi-9b")
    eng = SpecDecodeEngine(tcfg, _small_draft(TR, tcfg), max_new=max_new, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return (eng, eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu"),
            tcfg)


def test_eos_stops_request():
    eng, tp, dp, tcfg = _small_engine(32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    lens = np.full((2,), 8, np.int32)
    ref, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=96)
    eng.eos_id = int(ref[0, 2])
    # the eos value may occur earlier in the greedy stream (untrained models
    # repeat): generation stops at its FIRST occurrence
    first = int(np.where(ref[0] == eng.eos_id)[0][0])
    out, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=96)
    idx = np.where(out[0] == eng.eos_id)[0]
    assert len(idx) > 0 and idx[0] == first
    assert (out[0, idx[0] + 1:] == 0).all()


def test_eos_matches_jax():
    je, jt, jd, te, tt, td, tcfg = _engines("yi-9b", "noisy", max_new=16)
    toks, lens = _prompts(tcfg.vocab_size)
    ref, _, _ = te.generate(tt, td, toks, lens, s=0, cache_len=64)
    je.eos_id = te.eos_id = int(ref[1, 4])
    jout, _, jn = je.generate(jt, jd, toks, lens, s=3, cache_len=64)
    tout, _, tn = te.generate(tt, td, toks, lens, s=3, cache_len=64)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    assert tn == jn


def test_max_new_respected():
    eng, tp, dp, tcfg = _small_engine(9, seed=2)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    lens = np.full((2,), 8, np.int32)
    out, stats, _ = eng.generate(tp, dp, toks, lens, s=4, cache_len=96,
                                 collect_stats=True)
    assert out.shape[1] == 9
    assert sum(int(st.committed[0]) for st in stats) >= 9


def test_step_rejects_s_above_s_max():
    eng, tp, dp, tcfg = _small_engine(8)
    toks, lens = _prompts(tcfg.vocab_size)
    state = eng.prefill(tp, dp, toks, lens, cache_len=64)
    with pytest.raises(ValueError):
        eng.step(tp, dp, state, S_MAX + 1)


def test_prefill_rejects_prompts_under_three_tokens():
    eng, tp, dp, tcfg = _small_engine(8)
    toks, _ = _prompts(tcfg.vocab_size)
    with pytest.raises(ValueError):
        eng.prefill(tp, dp, toks, np.array([10, 2, 9], np.int32), cache_len=64)


def test_warmup_runs_every_pair():
    eng, tp, dp, _ = _small_engine(8)
    eng.warmup(tp, dp, batch_sizes=(1, 2), s_values=(0, 2), cache_len=32)
