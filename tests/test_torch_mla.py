"""MLA (DeepSeek-V2's multi-head latent attention) in the port against the
JAX package, on the CPU: the deepseek-v2-236b smoke config (2 layers, d
128, 4 heads of 32, ``kv_lora_rank`` 32, ``q_lora_rank`` 48, RoPE 16, 4
experts top-2 with 1 shared expert), with the JAX weights carried over by
``bridge.py`` and inputs made with numpy from a seed.

* the configs (full, smoke, draft), every port config's ``AttnConfig``
  against JAX's, and the parameter trees (``q_lora_rank`` 48 and 0);
* ``prefill`` (logits, ``ckv``, ``krope``, ``pos``) and an s 3
  ``decode_step``, with ``q_lora_rank`` 48 and 0 and on the dense family;
  stepwise decode against one block; ``prefill_chunk`` on a ring against
  JAX's (a middle chunk, a ragged final one, and one whose padded tail
  wraps onto live rows), and chunks against the whole prefill;
* a query row that sees no key (JAX's ``-1e30`` softmax: the mean of the
  ``ckv`` rows, not zeros);
* the engine: speculative = greedy at s 1, 3 and 5 against JAX's
  ``generate``, ``sample=True`` on JAX's own draws, and
  ``serve_continuous_live`` on contiguous rings, whole and chunked, against
  JAX's run;
* the guards: a paged pool raises ``NotImplementedError``, while
  ``forward`` and ``prefill_flash`` run; ``kv_quant`` leaves the MLA cache
  as JAX's does;
  K5's calls a layer; the launcher.

fp32 throughout.  Tolerance ``TOL`` (2e-5 absolute and relative) for
logits and cache rows after two layers (products summed in another order
by the two frameworks); positions, tokens and traces exact.
"""
import dataclasses

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
from repro_torch.configs import registry as TR
from repro_torch.configs.registry import _MODULES
from repro_torch.core.adaptive import AdaptiveController, SpeculationLUT
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as slaunch
from repro_torch.models import common as tcm
from repro_torch.models.transformer import DecoderLM
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (ContinuousEngineBackend, PrefillBudgetAdmit,
                                           serve_continuous_live)
from test_torch_chunked_prefill import _trace
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_qk_norm import small_draft
from test_torch_spec_sampling import jax_draws, replay  # noqa: F401  (fixture)

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "deepseek-v2-236b"
CACHE_LEN = 96
# the attention variants held against JAX: the smoke config, its full-rank q
# projection (q_lora_rank 0, ``wq``), and MLA on the dense family
VARIANTS = {"q_lora": {}, "q_full": {"q_lora_rank": 0}, "dense": {"dense": True}}


def _cfg(registry, variant="q_lora"):
    cfg = registry.get_smoke_config(ARCH)
    kw = dict(VARIANTS[variant])
    if kw.pop("dense", False):
        cfg = cfg.with_(family="dense", moe=None)
    if kw:
        cfg = cfg.with_(attn=dataclasses.replace(cfg.attn, **kw))
    return cfg


def pair(variant="q_lora"):
    """Both decoders on the JAX-initialised weights of a smoke variant."""
    jm, tm = JDecoderLM(_cfg(JR, variant)), DecoderLM(_cfg(TR, variant))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def assert_cache_close(tc, jc):
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def prefill_both(jm, jp, tm, tp, B=3, P=12, L=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, P - 5, P - 3][:B], np.int32)
    jl, jc, jt = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jm.init_cache(B, L),
                                     jnp.asarray(lens))
    tl, tc, tt = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(B, L, device="cpu"),
                            torch.from_numpy(lens))
    return (jl, jc, jt), (tl, tc, tt), rng


# ---------------------------------------------------------------------------
# configs and parameters


def test_configs_match_jax():
    for get in ("get_config", "get_smoke_config", "get_draft_config"):
        j, t = getattr(JR, get)(ARCH), getattr(TR, get)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "d_ff", "vocab_size", "norm_eps",
                  "source", "kv_quant"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert dataclasses.asdict(t.attn) == dataclasses.asdict(j.attn), get
        assert t.attn.vdim == j.attn.vdim
        assert (t.moe is None) == (j.moe is None)
        if t.moe is not None:
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe), get
    full = TR.get_config(ARCH)
    assert (full.attn.kind, full.attn.kv_lora_rank, full.attn.q_lora_rank,
            full.attn.rope_head_dim, full.attn.vdim) == ("mla", 512, 1536, 64, 128)
    assert (full.moe.n_experts, full.moe.top_k, full.moe.n_shared) == (160, 6, 2)


@pytest.mark.parametrize("arch", sorted(_MODULES))
def test_attn_configs_match_jax(arch):
    """Every port config's attention config, MLA fields and ``kind``
    included, equals JAX's field for field (the GQA ones at their
    defaults)."""
    for get in ("get_config", "get_smoke_config", "get_draft_config"):
        j, t = getattr(JR, get)(arch), getattr(TR, get)(arch)
        assert (t.attn is None) == (j.attn is None), get
        if t.attn is not None:
            assert dataclasses.asdict(t.attn) == dataclasses.asdict(j.attn), get


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_tree_matches_jax_layout(variant):
    """Same nested keys and stacked shapes as JAX's tree (MLA's ``q_norm``
    is the q-lora norm, ``[q_lora_rank]``; no ``wk``/``wv``), ones for the
    norms."""
    jm, tm = JDecoderLM(_cfg(JR, variant)), DecoderLM(_cfg(TR, variant))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jm.shapes()) == _shapes(tp)
    layers = tp["layers"]
    assert "wk" not in layers and "wv" not in layers and "k_norm" not in layers
    a = tm.cfg.attn
    if a.q_lora_rank:
        assert layers["q_norm"].shape == (2, a.q_lora_rank) and "wq" not in layers
    else:
        assert "q_norm" not in layers and layers["wq"].shape == (2, 128, 4, 48)
    for name in ("attn_norm", "mlp_norm", "kv_norm") + (("q_norm",) if a.q_lora_rank else ()):
        assert bool((layers[name] == 1).all()), name


# ---------------------------------------------------------------------------
# the model on the ring


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_verify_match_jax(variant):
    """The prefill's logits and ``ckv``/``krope``/``pos``, then an s 3
    verify (T 4) over that cache, against JAX's."""
    jm, jp, tm, tp = pair(variant)
    (jl, jc, jt), (tl, tc, tt), rng = prefill_both(jm, jp, tm, tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_cache_close(tc, jc)
    feed = rng.integers(0, jm.cfg.vocab_size, (3, 4)).astype(np.int32)
    jl2, jc2 = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jc, jt + 1)
    tl2, tc2 = tm.decode_step(tp, torch.from_numpy(feed), tc, tt + 1)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    assert_cache_close(tc2, jc2)


def test_stepwise_decode_equals_block_decode():
    """Four T = 1 steps give the logits and cache of one T = 4 verify."""
    _, _, tm, tp = pair()
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 10)).astype(np.int32))
    lens = torch.tensor([10, 6], dtype=torch.int32)
    feed = torch.from_numpy(rng.integers(0, 512, (2, 4)).astype(np.int32))
    outs = []
    for block in (True, False):
        _, cache, seq = tm.prefill(tp, toks, tm.init_cache(2, 32, device="cpu"), lens)
        if block:
            lg, cache = tm.decode_step(tp, feed, cache, seq + 1)
        else:
            parts = []
            for t in range(4):
                lg_t, cache = tm.decode_step(tp, feed[:, t:t + 1], cache, seq + 1 + t)
                parts.append(lg_t)
            lg = torch.cat(parts, dim=1)
        outs.append((lg, cache))
    (lb, cb), (ls, cs) = outs
    np.testing.assert_allclose(ls.numpy(), lb.numpy(), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(cs[name].numpy(), cb[name].numpy(), **TOL)
    assert torch.equal(cs["pos"], cb["pos"])


def _ring(tm, B, L, prefix, rng):
    """An MLA ring as numpy: random ``ckv``/``krope`` in every row (so that a
    clobbered row shows), row p % L holding position p for p < prefix[b]."""
    a, nL = tm.cfg.attn, tm.cfg.n_layers
    pos = np.full((B, L), -1, np.int32)
    for b in range(B):
        pos[b, np.arange(prefix[b]) % L] = np.arange(prefix[b])
    return dict(ckv=rng.standard_normal((nL, B, L, a.kv_lora_rank)).astype(np.float32),
                krope=rng.standard_normal((nL, B, L, a.rope_head_dim)).astype(np.float32),
                pos=pos)


# (ring L, chunk T, offset [B], limit [B]); "wrap": the padded tail of the
# ragged final chunk lands on rows 0.. that hold the live prefix
RING_CASES = {
    "middle": (48, 8, [16, 8], [40, 30]),
    "ragged_final": (48, 16, [16, 12], [21, 20]),
    "wrap": (24, 16, [16, 14], [20, 21]),
}


@pytest.mark.parametrize("rows_limit", [None, 32], ids=["all_rows", "rows_limit"])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_prefill_chunk_matches_jax(case, rows_limit):
    L, T, offset, limit = RING_CASES[case]
    R_ = None if rows_limit is None else min(rows_limit, L)
    jm, jp, tm, tp = pair()
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
    assert_cache_close(tc, jc)
    # every row outside [offset, limit) is bit for bit as it was
    for b in range(B):
        kept = np.setdiff1d(np.arange(L), np.arange(off[b], lim[b]) % L)
        np.testing.assert_array_equal(tc["pos"].numpy()[b, kept], c["pos"][b, kept])
        for name in ("ckv", "krope"):
            np.testing.assert_array_equal(tc[name].numpy()[:, b, kept], c[name][:, b, kept])
    if case == "wrap":   # the padded tail did reach live rows of the prefix
        assert all((np.arange(lim[b], off[b] + T) % L < off[b]).any() for b in range(B))


def test_prefill_chunks_equal_the_whole_prefill():
    """A 21-token prompt fed as chunks of 8 (the last ragged, padded to 8)
    leaves the cache and last logits of one whole prefill."""
    _, _, tm, tp = pair()
    rng = np.random.default_rng(4)
    n, L = 21, 40
    toks = torch.from_numpy(rng.integers(0, 512, (1, 24)).astype(np.int32))
    lw, cw, _ = tm.prefill(tp, toks[:, :n], tm.init_cache(1, L, device="cpu"))
    cache = tm.init_cache(1, L, device="cpu")
    for start in range(0, n, 8):
        lg, cache = tm.prefill_chunk(tp, toks[:, start:start + 8], cache,
                                     torch.tensor([start]), torch.tensor([n]), rows_limit=32)
    np.testing.assert_allclose(lg[0, (n - 1) % 8].numpy(), lw[0].numpy(), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(cache[name].numpy(), cw[name].numpy(), **TOL)
    assert torch.equal(cache["pos"], cw["pos"])


def test_fully_masked_row_matches_jax():
    """A query row that sees no key: JAX's ``-1e30`` softmax spreads it
    evenly over the attended rows, so its output is the mean of the
    ``ckv`` rows through ``W_uv`` and ``wo``, not zeros (K1's rule)."""
    jm, jp, tm, tp = pair()
    rng = np.random.default_rng(6)
    B, T, L = 2, 3, 16
    c = _ring(tm, B, L, [9, 0], rng)
    x = (0.5 * rng.standard_normal((B, T, 128))).astype(np.float32)
    positions = np.array([[9, 10, 11], [0, 1, 2]], np.int32)
    rows = positions % L
    pos_arr = c["pos"].copy()
    pos_arr[0, rows[0]] = positions[0]          # slot 1's new rows stay hidden
    jlp = jax.tree.map(lambda p: p[0], jp["layers"])
    jout, jlc = jax.jit(jm._attn_decode, static_argnums=(6,))(
        jlp, jnp.asarray(x), jnp.asarray(positions),
        {n: jnp.asarray(c[n][0]) for n in ("ckv", "krope")}, jnp.asarray(pos_arr),
        jnp.asarray(rows), 0)
    lc = {n: torch.from_numpy(c[n][0].copy()) for n in ("ckv", "krope")}
    tlp = {k: v[0] for k, v in tp["layers"].items() if k != "moe"}
    rope = tcm.rope_table(torch.from_numpy(positions), 16, tm.cfg.attn.rope_theta)
    tout = tm._attn_decode(tlp, torch.from_numpy(x), torch.from_numpy(positions), lc,
                           torch.from_numpy(pos_arr), torch.from_numpy(rows).long(), rope)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for n in ("ckv", "krope"):
        np.testing.assert_allclose(lc[n].numpy(), np.asarray(jlc[n]), **TOL)
    mean = lc["ckv"][1].mean(0)                 # slot 1: every row of its ring
    a = tm.cfg.attn
    want = torch.einsum("l,lhv->hv", mean, tlp["w_uv"]).reshape(-1) @ tlp["wo"].reshape(
        a.n_heads * a.vdim, -1)
    for t in range(T):
        np.testing.assert_allclose(tout[1, t].numpy(), want.numpy(), **TOL)
    assert float(tout[1].abs().max()) > 1e-3


def test_kv_quant_leaves_the_mla_cache_as_jax():
    """``kv_quant`` does not touch an MLA cache, in either package: the same
    leaves, dtypes and shapes as without it, and the same prefill."""
    jm, jp, _, tp = pair()
    tm = DecoderLM(_cfg(TR).with_(kv_quant=True))
    jq = JDecoderLM(_cfg(JR).with_(kv_quant=True))
    jc, tc = jq.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    assert sorted(tc) == sorted(jc) == ["ckv", "krope", "pos"]
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)
    (jl, jcache, _), (tl, tcache, _), _ = prefill_both(jq, jp, tm, tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tcache, jcache)
    _, (tl0, _, _), _ = prefill_both(jm, jp, DecoderLM(_cfg(TR)), tp)
    assert torch.equal(tl, tl0)


@pytest.mark.parametrize("variant,per_layer", [("q_lora", 4), ("q_full", 3)])
def test_k5_calls_a_layer(variant, per_layer):
    """K5 (the plain version here) runs the attention and MLP norms, the
    q-lora norm when there is one and ``kv_norm``: 4 or 3 calls a layer,
    plus the final norm."""
    _, _, tm, tp = pair(variant)
    before = ops.PLAIN_RMSNORM.launches
    tm.prefill(tp, torch.zeros((1, 6), dtype=torch.int32), tm.init_cache(1, 8, device="cpu"))
    assert ops.PLAIN_RMSNORM.launches - before == per_layer * tm.cfg.n_layers + 1


def test_guards_raise():
    """MLA serves on the ring only: the paged pool raises as JAX's does,
    while ``forward`` and ``prefill_flash`` (K4 at q/k 48, v 32 here; 192
    and 128 at full width) run (``test_torch_mla_full.py`` holds them
    against JAX); an unknown attention kind names item 12."""
    jm, _, tm, tp = pair()
    with pytest.raises(NotImplementedError, match="paged"):
        jm.init_paged_cache(8, 8)
    with pytest.raises(NotImplementedError, match="paged"):
        tm.init_paged_cache(8, 8, device="cpu")
    toks = torch.zeros((1, 6), dtype=torch.int32)
    V = tm.cfg.vocab_size
    logits, aux = tm.forward(tp, toks)
    assert logits.shape[:2] == (1, 6) and bool(torch.isfinite(logits[..., :V]).all())
    assert bool(torch.isfinite(aux))
    last, cache, lens = tm.prefill_flash(tp, toks, tm.init_cache(1, 8, device="cpu"))
    assert bool(torch.isfinite(last[:, :V]).all()) and lens.tolist() == [6]
    assert cache["pos"][0].tolist() == [0, 1, 2, 3, 4, 5, -1, -1]
    with pytest.raises(NotImplementedError, match="item 12"):
        DecoderLM(_cfg(TR).with_(attn=dataclasses.replace(_cfg(TR).attn, kind="linear")))


def test_engine_guards_raise_where_jax_does(engines):
    """A paged pool, the prefix cache and the mixed launch need a paged
    pool, which an MLA target has in neither package; the contiguous ring
    can chunk."""
    je, jt, jd, te, tt, td, _ = engines
    for eng, tp, dp, backend in ((je, jt, jd, jsched.ContinuousEngineBackend),
                                 (te, tt, td, ContinuousEngineBackend)):
        with pytest.raises(NotImplementedError):
            eng.init_slots(2, 32, block_size=8)
        for kw in ({}, {"prefix_cache": True}, {"mixed_launch": True}):
            with pytest.raises(NotImplementedError):
                backend(eng, tp, dp, capacity=2, cache_len=32, block_size=8, **kw)
        for kw in ({"prefix_cache": True}, {"mixed_launch": True}):
            with pytest.raises(ValueError):
                backend(eng, tp, dp, capacity=2, cache_len=32, **kw)
        assert backend(eng, tp, dp, capacity=2, cache_len=32).can_chunk


# ---------------------------------------------------------------------------
# the engine


def _engines(sample=False, max_new=24):
    jcfg, tcfg = _cfg(JR), _cfg(TR)
    je = JEngine(jcfg, small_draft(JR, jcfg), max_new=max_new, sample=sample)
    te = SpecDecodeEngine(tcfg, small_draft(TR, tcfg), max_new=max_new, device="cpu",
                          sample=sample)
    jt = jax.tree.map(np.asarray, je.target.init(jax.random.PRNGKey(0)))
    jd = jax.tree.map(np.asarray, je.draft.init(jax.random.PRNGKey(1)))
    return je, jt, jd, te, bridge.to_torch(jt, "cpu"), bridge.to_torch(jd, "cpu"), tcfg


@pytest.fixture(scope="module")
def engines():
    """The greedy JAX and port engines on the same weights (shared, so
    that the JAX engine compiles its steps once)."""
    return _engines()


def test_spec_equals_greedy_against_jax(engines):
    """The smoke config's capacity factor 2.0 = n_experts / top_k drops
    nothing, so speculation cannot change a token: the port's tokens at s
    1, 3 and 5 equal JAX's greedy ``generate`` token for token, and JAX's
    own at s 3, with the same accepted counts."""
    je, jt, jd, te, tt, td, tcfg = engines
    assert tcfg.moe.capacity_factor == tcfg.moe.n_experts / tcfg.moe.top_k
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    lens = np.array([10, 7, 9], np.int32)
    ref, _, _ = je.generate(jt, jd, toks, lens, s=0, cache_len=CACHE_LEN)
    j3, jstats, _ = je.generate(jt, jd, toks, lens, s=3, cache_len=CACHE_LEN,
                                collect_stats=True)
    np.testing.assert_array_equal(np.asarray(j3), np.asarray(ref))
    for s in (0, 1, 3, 5):
        out, stats, _ = te.generate(tt, td, toks, lens, s=s, cache_len=CACHE_LEN,
                                    collect_stats=True)
        np.testing.assert_array_equal(out, np.asarray(ref), err_msg=f"s={s}")
        if s == 3:
            assert len(stats) == len(jstats)
            for a, b in zip(stats, jstats):
                np.testing.assert_array_equal(a.accepted, np.asarray(b.accepted))


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _slots(eng, tp, dp, vocab):
    """Three live slots of ragged prompts on contiguous rings, one empty."""
    rng = np.random.default_rng(5)
    state = eng.init_slots(4, CACHE_LEN)
    for slot, n in enumerate((9, 13, 6)):
        p = rng.integers(0, vocab, (n,)).astype(np.int32)
        state = eng.prefill_into(tp, dp, state, slot, p, n, CACHE_LEN)
    return state


@pytest.fixture(scope="module")
def sampling_engines():
    return _engines(sample=True)


@pytest.mark.parametrize("s", [1, 3])
def test_sampled_steps_match_jax(sampling_engines, replay, s):  # noqa: F811  (fixture)
    """``sample=True`` on JAX's draws for each key: three steps of the slot
    pool (an empty slot takes them too) give JAX's accepted and committed
    counts, ``out``, ``seq_lens``, ``last2``, ``n_generated`` and
    ``done``."""
    je, jt, jd, te, tt, td, tcfg = sampling_engines
    js, ts = _slots(je, jt, jd, tcfg.vocab_size), _slots(te, tt, td, tcfg.vocab_size)
    V = te.target.padded_vocab
    for i in range(3):
        key = jax.random.PRNGKey(100 * s + i)
        replay["draws"] = jax_draws(key, 4, s, V)
        js, jst = je.step(jt, jd, js, s, key)
        ts, tst = te.step(tt, td, ts, s, torch.Generator())
        np.testing.assert_array_equal(tst.accepted, np.asarray(jst.accepted))
        np.testing.assert_array_equal(tst.committed, np.asarray(jst.committed))
        for name in ("out", "seq_lens", "last2", "n_generated", "done"):
            np.testing.assert_array_equal(_host(getattr(ts, name)), _host(getattr(js, name)),
                                          err_msg=f"step {i}: {name}")


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_live_serving_on_rings_matches_jax(engines, chunked):
    """``serve_continuous_live`` on contiguous rings (no block pool), whole
    prompts or chunked under a 16-token budget: the two packages give equal
    admitted, chunked and committed traces and equal tokens per request."""
    je, jt, jd, te, tt, td, tcfg = engines
    geo = dict(capacity=4, cache_len=CACHE_LEN, collect_outputs=True, warm_s=(2, 3, 4))
    runs = []
    for eng, tp, dp, cls, backend_cls, serve, policy, ctrl in (
            (je, jt, jd, JRequest, jsched.ContinuousEngineBackend,
             jsched.serve_continuous_live, jsched.PrefillBudgetAdmit,
             JController(lut=JLUT({1: 4, 2: 3, 4: 2}))),
            (te, tt, td, Request, ContinuousEngineBackend, serve_continuous_live,
             PrefillBudgetAdmit, AdaptiveController(lut=SpeculationLUT({1: 4, 2: 3, 4: 2})))):
        backend = backend_cls(eng, tp, dp, **geo)
        kw = {"policy": policy(token_budget=16, chunk=8)} if chunked else {}
        res = serve(_trace(tcfg.vocab_size, n=6, cls=cls), eng, tp, dp, ctrl,
                    backend=backend, **kw)
        runs.append((res, backend))
    (jres, jbe), (tres, tbe) = runs
    assert all(r.finish is not None and r.n_generated == r.max_new for r in tres.requests)
    assert any(t.chunked for t in tres.trace) == chunked
    for field in ("admitted", "chunked", "committed"):
        assert ([getattr(t, field) for t in tres.trace]
                == [getattr(t, field) for t in jres.trace]), field
    for r in tres.requests:
        np.testing.assert_array_equal(tbe.outputs[r.rid], np.asarray(jbe.outputs[r.rid]),
                                      err_msg=f"rid {r.rid}")


def test_launcher_serves_deepseek_v2():
    """``--arch deepseek-v2-236b`` through the registry, its depth cut by
    ``--layers``."""
    out = slaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--dtype", "float32",
                        "--requests", "4", "--max-new", "6", "--profile-bs", "1,2",
                        "--s-max", "2", "--interval", "0.01", "--layers", "1"])
    assert out["arch"] == ARCH + "-smoke" and out["n_layers"] == 1
    assert out["adaptive"]["n"] == 4 and out["no_spec"]["n"] == 4
