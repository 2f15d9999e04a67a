"""Stochastic speculative sampling (``sample=True``) in the port, on the CPU.

* Replay parity with JAX: the JAX engine steps with a key; the port's
  engine steps with ``_sample_draws`` monkeypatched to return JAX's own
  draws for that key (the draft's ``gumbel(fold_in(k_draft, i))``, the
  acceptance ``uniform(k_acc)``, the residual's ``gumbel(k_res)``), on a
  contiguous pool, a paged pool (the gather path) and the mixed
  verify+chunk step, at s 0, 1 and 3, three chained steps with three keys,
  an empty (done) slot in every pool; and on a Mamba-2 target.  In fp32
  ``out``, the accept and commit counts, ``seq_lens``, ``last2``,
  ``n_generated`` and ``done`` must be identical.  First, that
  ``jax.random.categorical`` is Gumbel-max on the installed JAX, which is
  what makes the replay exact.
* The port alone (``tests/test_spec_sampling.py`` ported): draft = target
  accepts everything; the bounds on the counts; the first token's
  distribution against the target's softmax (total variation over the top
  20 below 0.12, from 600 rows of one batched step); the same generator
  seed gives the same tokens; the ``rng=None`` fallback is a generator
  seeded with ``sum(n_generated)``; ``sample=False`` is unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core import spec_decode
from repro_torch.core.spec_decode import SpecDecodeEngine
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_mamba2_serving import _draft as mamba_draft
from test_torch_mamba2_serving import _weights as mamba_weights
from test_torch_mixed_launch import _draft, _mixed_setup

CACHE_LEN = 96
BLOCK = 8
STEP_FIELDS = ("out", "seq_lens", "last2", "n_generated", "done")


def test_categorical_is_gumbel_max():
    """``categorical(k, x) == argmax(x + gumbel(k, x.shape, x.dtype))``."""
    x = jnp.asarray(np.random.default_rng(0).standard_normal((5, 512)).astype(np.float32))
    for seed in range(4):
        k = jax.random.PRNGKey(seed)
        want = jnp.argmax(x + jax.random.gumbel(k, x.shape, x.dtype), axis=-1)
        np.testing.assert_array_equal(np.asarray(jax.random.categorical(k, x, axis=-1)),
                                      np.asarray(want))


def jax_draws(key, B, s, V):
    """The draws JAX's sampled step takes from ``key``, in the layout of
    ``_sample_draws``."""
    k_draft, k_acc, k_res = jax.random.split(key, 3)
    g = [np.asarray(jax.random.gumbel(jax.random.fold_in(k_draft, i), (B, V), jnp.float32))
         for i in range(s)]
    g_draft = np.stack(g) if s else np.zeros((0, B, V), np.float32)
    u = np.asarray(jax.random.uniform(k_acc, (B, s)))
    g_res = np.asarray(jax.random.gumbel(k_res, (B, V), jnp.float32))
    return tuple(torch.from_numpy(np.array(a)) for a in (g_draft, u, g_res))


@pytest.fixture
def replay(monkeypatch):
    """Route the port's draws through a slot that each test fills with
    JAX's draws for its key."""
    slot = {}

    def draws(rng, B, s, V, device):
        got = slot.pop("draws")
        assert tuple(got[0].shape) == (s, B, V) and tuple(got[2].shape) == (B, V)
        return tuple(t.to(device) for t in got)
    monkeypatch.setattr(spec_decode, "_sample_draws", draws)
    return slot


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port engine, both sampling, on the same weights."""
    jcfg, tcfg = JR.get_smoke_config("yi-9b"), R.get_smoke_config("yi-9b")
    je = JEngine(jcfg, _draft(JR, jcfg), max_new=24, sample=True)
    te = SpecDecodeEngine(tcfg, _draft(R, tcfg), max_new=24, device="cpu", sample=True)
    jt = jax.tree.map(np.asarray, je.target.init(jax.random.PRNGKey(0)))
    jd = jax.tree.map(np.asarray, je.draft.init(jax.random.PRNGKey(1)))
    return je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"), tcfg


def _pool(eng, tp, dp, vocab, paged):
    """Three live slots of ragged prompts and one empty (done) slot."""
    rng = np.random.default_rng(5)
    state = eng.init_slots(4, CACHE_LEN, **({"block_size": BLOCK} if paged else {}))
    for slot, n in enumerate((9, 13, 6)):
        p = rng.integers(0, vocab, (n,)).astype(np.int32)
        state = eng.prefill_into(tp, dp, state, slot, p, n, CACHE_LEN)
    return state


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same_step(ts, js, tst, jst, what):
    np.testing.assert_array_equal(tst.accepted, np.asarray(jst.accepted), err_msg=what)
    np.testing.assert_array_equal(tst.committed, np.asarray(jst.committed), err_msg=what)
    for name in STEP_FIELDS:
        np.testing.assert_array_equal(_host(getattr(ts, name)), _host(getattr(js, name)),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("s", [0, 1, 3])
@pytest.mark.parametrize("route", ["ring", "paged", "mixed"])
def test_replay_parity_with_jax(pair, replay, route, s):
    je, jt, jd, te, tt, td, tcfg = pair
    V = te.target.padded_vocab
    if route == "mixed":
        js, jchunk = _mixed_setup(je, jt, jd, tcfg.vocab_size)
        ts, tchunk = _mixed_setup(te, tt, td, tcfg.vocab_size)
    else:
        js = _pool(je, jt, jd, tcfg.vocab_size, route == "paged")
        ts = _pool(te, tt, td, tcfg.vocab_size, route == "paged")
    B = ts.seq_lens.shape[0]
    assert bool(ts.done.any())            # an empty or parked slot takes the step too
    accepted = 0
    for i in range(3):
        key = jax.random.PRNGKey(100 * s + i)
        replay["draws"] = jax_draws(key, B, s, V)
        if route == "mixed" and i == 0:
            js, jst = je.step_with_chunk(jt, jd, js, s, jchunk, rng=key)
            ts, tst = te.step_with_chunk(tt, td, ts, s, tchunk, rng=torch.Generator())
        else:
            js, jst = je.step(jt, jd, js, s, key)
            ts, tst = te.step(tt, td, ts, s, torch.Generator())
        _same_step(ts, js, tst, jst, f"{route} s={s} step {i}")
        accepted += int(tst.accepted.sum())
    if s == 3:
        assert accepted > 0               # the acceptance branch ran


@pytest.mark.parametrize("s", [1, 3])
def test_replay_parity_with_jax_mamba2(replay, s):
    """A Mamba-2 target: ``commit`` takes the state checkpoint at the
    sampled accept count."""
    jt, jd, jdc = mamba_weights("part")
    jcfg, tcfg = JR.get_smoke_config("mamba2-1.3b"), R.get_smoke_config("mamba2-1.3b")
    je = JEngine(jcfg, jdc, max_new=12, sample=True)
    te = SpecDecodeEngine(tcfg, mamba_draft(R, tcfg, 128, 4), max_new=12, device="cpu",
                          sample=True)
    tt, td = bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    lens = np.array([10, 7, 9], np.int32)
    js = je.prefill(jt, jd, toks, lens, 64)
    ts = te.prefill(tt, td, toks, lens, 64)
    V = te.target.padded_vocab
    accepted = 0
    for i in range(3):
        key = jax.random.PRNGKey(7 + i)
        replay["draws"] = jax_draws(key, 3, s, V)
        js, jst = je.step(jt, jd, js, s, key)
        ts, tst = te.step(tt, td, ts, s, torch.Generator())
        _same_step(ts, js, tst, jst, f"mamba2 s={s} step {i}")
        accepted += int(tst.accepted.sum())
    assert accepted > 0


# ---------------------------------------------------------------------------
# the port alone


def _setup(sample=True, temperature=1.0, draft_same=False):
    tcfg = R.get_smoke_config("yi-9b")
    dcfg = tcfg if draft_same else dataclasses.replace(
        R.get_smoke_config("internlm2-1.8b"), vocab_size=tcfg.vocab_size)
    eng = SpecDecodeEngine(tcfg, dcfg, max_new=8, device="cpu", sample=sample,
                           temperature=temperature)
    gen = torch.Generator().manual_seed(0)
    tp = eng.target.init(gen, device="cpu")
    dp = tp if draft_same else eng.draft.init(gen, device="cpu")
    return eng, tp, dp, tcfg


def _prompts(vocab, B, seed, n=8):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(np.int32)
    return toks, np.full((B,), n, np.int32)


def test_draft_equals_target_accepts_everything():
    eng, tp, dp, tcfg = _setup(draft_same=True)
    toks, lens = _prompts(tcfg.vocab_size, 2, 0)
    state = eng.prefill(tp, dp, toks, lens, 64)
    for i in range(3):
        live = ~state.done.numpy()
        state, st = eng.step(tp, dp, state, 4, torch.Generator().manual_seed(i))
        # p == q for every draft token: acceptance probability 1, a == s
        assert (st.accepted[live] == 4).all()


def test_acceptance_bounds_hold_when_sampling():
    eng, tp, dp, tcfg = _setup()
    toks, lens = _prompts(tcfg.vocab_size, 3, 1)
    state = eng.prefill(tp, dp, toks, lens, 64)
    for i in range(3):
        state, st = eng.step(tp, dp, state, 5, torch.Generator().manual_seed(10 + i))
        assert (st.accepted >= 0).all() and (st.accepted <= 5).all()
        assert (st.committed <= st.accepted + 1).all()
        assert (state.out.numpy() < tcfg.vocab_size).all()   # no padded vocab id


def test_first_token_distribution_matches_target():
    """The first committed token of 600 rows of one s = 3 step against the
    target's softmax at the prompt tip: total variation over its top 20
    below 0.12."""
    eng, tp, dp, tcfg = _setup()
    N = 600
    toks, lens = _prompts(tcfg.vocab_size, 1, 2)
    m = eng.target
    cache = m.init_cache(1, 64, torch.float32, "cpu")
    logits, _, _ = m.prefill(tp, torch.from_numpy(toks).long(), cache,
                             prompt_lens=torch.from_numpy(lens) - 1)
    p = torch.softmax(logits[0], -1).numpy()
    state = eng.prefill(tp, dp, np.repeat(toks, N, 0), np.repeat(lens, N), 64)
    state, _ = eng.step(tp, dp, state, 3, torch.Generator().manual_seed(1000))
    first = state.out[:, 0].numpy()
    emp = np.bincount(first, minlength=p.shape[0])[:p.shape[0]] / N
    top = np.argsort(p)[::-1][:20]
    tv_top = 0.5 * np.abs(emp[top] - p[top]).sum()
    assert tv_top < 0.12, (tv_top, p[top][:5], emp[top][:5])


def test_same_seed_same_tokens():
    eng, tp, dp, tcfg = _setup()
    toks, lens = _prompts(tcfg.vocab_size, 3, 4)
    a, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=64, key=5)
    b, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=64, key=5)
    c, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=64, key=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_fallback_rng_is_seeded_by_tokens_generated():
    """``rng=None`` draws from a generator seeded with ``sum(n_generated)``."""
    eng, tp, dp, tcfg = _setup()
    toks, lens = _prompts(tcfg.vocab_size, 3, 6)
    sa = eng.prefill(tp, dp, toks, lens, 64)
    sb = eng.prefill(tp, dp, toks, lens, 64)
    for _ in range(3):
        seed = int(sb.n_generated.sum())
        sa, sta = eng.step(tp, dp, sa, 2)
        sb, stb = eng.step(tp, dp, sb, 2, torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(sta.accepted, stb.accepted)
        np.testing.assert_array_equal(sa.out.numpy(), sb.out.numpy())
    assert int(sa.n_generated.sum()) > 0


def test_greedy_mode_unaffected():
    """``sample=False``: speculative tokens are the greedy tokens and equal
    the JAX engine's."""
    eng, tp, dp, tcfg = _setup(sample=False)
    toks, lens = _prompts(tcfg.vocab_size, 2, 3)
    ref, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=64)
    spec, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=64)
    np.testing.assert_array_equal(ref, spec)
    jcfg = JR.get_smoke_config("yi-9b")
    je = JEngine(jcfg, dataclasses.replace(JR.get_smoke_config("internlm2-1.8b"),
                                           vocab_size=jcfg.vocab_size), max_new=8)
    jout, _, _ = je.generate(bridge.to_numpy(tp), bridge.to_numpy(dp), toks, lens, s=3,
                             cache_len=64)
    np.testing.assert_array_equal(spec, np.asarray(jout))
