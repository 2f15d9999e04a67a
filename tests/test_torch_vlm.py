"""The VLM family (paligemma-3b) in the port against the JAX package, on the
CPU: the smoke config (2 layers, d 128, 4 query heads over 1 kv-head of 32,
a bidirectional prefix of 8 rows, vocabulary 512), with the JAX weights
carried over by ``bridge.py`` and inputs made with numpy from a seed.

* the configs and the registry, the parameter trees, the full config's
  parameter count;
* ``forward`` (logits over prefix and tokens), ``prefill`` and
  ``prefill_flash`` (logits, every cache leaf, the lengths counting the
  prefix) and ``decode_step`` at T 1 and 4 after them, with
  ``prefix_embeds``, against JAX's, with the prefix mask bidirectional and
  causal; decode after prefill against ``forward``'s rows;
* the engine with ``target_extras={"prefix_embeds": ...}``: greedy tokens
  against JAX's ``generate``, speculative = greedy at s 1 and 3, the slot
  pool on rings and on a paged pool against ``generate``;
* JAX's paged ``prefill_into`` reserving blocks for the prompt only, so its
  paged pool loses the rows past them and its tokens part from its own
  ``generate``, where the port's do not;
* the guards: no ``prefix_embeds``, chunked prefill and the prefix cache,
  the continuous runtime and the launchers, K4's backward at head dim 256;
  the plain kernels' calls (K1 a layer in a prefill, K4 a layer in a
  ``forward`` and a ``prefill_flash``).

fp32 throughout; tolerance ``TOL`` (1e-5 absolute and relative) for logits
and cache rows; positions, lengths and tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import flash_attn as K4
from repro_torch.kernels import ops
from repro_torch.launch import serve as slaunch
from repro_torch.launch import train as tlaunch
from repro_torch.models.transformer import DecoderLM
from repro_torch.serving.scheduler import ContinuousEngineBackend
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_qk_norm import small_draft

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "paligemma-3b"
CACHE_LEN = 48
MAX_NEW = 12


def _models(bidirectional=True):
    jc, tc = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    if not bidirectional:
        jc = dataclasses.replace(jc, bidirectional_prefix=False)
        tc = tc.with_(bidirectional_prefix=False)
    return JDecoderLM(jc), DecoderLM(tc)


@pytest.fixture(scope="module")
def pair():
    """Both models on the JAX-initialised weights of the smoke config."""
    jm, tm = _models()
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def causal_pair(pair):
    """The same weights under a causal prefix mask (``bidirectional_prefix``
    off: the prefix rows are plain context)."""
    jm, tm = _models(bidirectional=False)
    return jm, pair[1], tm, pair[3]


def inputs(cfg, B=2, T=10, seed=0):
    """Tokens [B, T], ragged prompt lengths and ``prefix_embeds [B, P, d]``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([T, T - 3, T - 1][:B], np.int32)
    pe = (0.1 * rng.standard_normal((B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    return toks, lens, pe


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# configs and parameters


def test_configs_match_jax():
    for get in ("get_config", "get_smoke_config", "get_draft_config"):
        j, t = getattr(JR, get)(ARCH), getattr(TR, get)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "d_ff", "vocab_size", "norm_eps",
                  "source", "prefix_len", "bidirectional_prefix", "tie_embeddings"):
            assert getattr(t, f, False) == getattr(j, f), (get, f)
        assert dataclasses.asdict(t.attn) == {k: v for k, v in dataclasses.asdict(j.attn).items()
                                              if k in dataclasses.asdict(t.attn)}, get
    full = TR.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.attn.n_heads, full.attn.n_kv_heads,
            full.attn.head_dim, full.prefix_len, full.bidirectional_prefix) == (
        18, 2048, 8, 1, 256, 256, True)
    draft = TR.get_draft_config(ARCH)
    assert (draft.n_layers, draft.d_model, draft.attn.head_dim, draft.family) == (
        4, 512, 64, "dense")
    model = TR.build_model(full)
    assert isinstance(model, DecoderLM) and model.step_prefix == 256
    n = sum(int(np.prod(d.full_shape(full.n_layers))) for d in _defs(model.param_defs()))
    assert n == 3_036_751_872          # about 3.04 B, 6.07 GB in bf16 (untied embeddings)


def _defs(tree):
    for v in tree.values():
        yield from (_defs(v) if isinstance(v, dict) else [v])


def test_param_trees_match_jax(pair):
    jm, jp, tm, tp = pair

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert shapes(own) == shapes(jp)


# ---------------------------------------------------------------------------
# the model's entry points with prefix_embeds


@pytest.mark.parametrize("mask", ["bidirectional", "causal"])
def test_forward_matches_jax(pair, causal_pair, mask):
    """Logits over the P prefix rows and the T tokens ([B, P + T, V])."""
    jm, jp, tm, tp = pair if mask == "bidirectional" else causal_pair
    toks, _, pe = inputs(tm.cfg)
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks), jnp.asarray(pe))
    tl, aux = tm.forward(tp, torch.from_numpy(toks), torch.from_numpy(pe))
    assert tl.shape == (2, tm.cfg.prefix_len + toks.shape[1], tm.padded_vocab)
    close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("mask", ["bidirectional", "causal"])
@pytest.mark.parametrize("entry", ["prefill", "prefill_flash"])
def test_prefill_and_decode_match_jax(pair, causal_pair, entry, mask):
    """Last-token logits, every cache leaf (positions exact) and the
    lengths (prompt + P), then decode steps of 1 and 4 tokens after it."""
    jm, jp, tm, tp = pair if mask == "bidirectional" else causal_pair
    toks, lens, pe = inputs(tm.cfg, B=3)
    jl, jc, jn = jax.jit(getattr(jm, entry))(jp, jnp.asarray(toks), jm.init_cache(3, CACHE_LEN),
                                             jnp.asarray(lens), jnp.asarray(pe))
    tl, tc, tn = getattr(tm, entry)(tp, torch.from_numpy(toks),
                                    tm.init_cache(3, CACHE_LEN, device="cpu"),
                                    torch.from_numpy(lens), torch.from_numpy(pe))
    close(tl, jl)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tn.numpy(), lens + tm.cfg.prefix_len)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for k in ("k", "v"):
        close(tc[k], jc[k])
    rng = np.random.default_rng(5)
    seq = np.asarray(jn) + 1
    for T in (1, 4):
        feed = rng.integers(0, tm.cfg.vocab_size, (3, T)).astype(np.int32)
        jd, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jc, jnp.asarray(seq))
        td, tc = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(seq))
        close(td, jd)
        for k in ("k", "v"):
            close(tc[k], jc[k])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        seq = seq + T


def test_decode_after_prefill_matches_forward(pair):
    """An unpadded prefill of the first 6 tokens, then the other 4 in one
    decode step, against ``forward``'s rows at the same positions: the step
    sees the prefix as the forward does."""
    _, _, tm, tp = pair
    toks, _, pe = inputs(tm.cfg)
    t, x = torch.from_numpy(toks), torch.from_numpy(pe)
    full, _ = tm.forward(tp, t, x)
    lg, cache, n = tm.prefill(tp, t[:, :6], tm.init_cache(2, CACHE_LEN, device="cpu"),
                              prefix_embeds=x)
    steps, _ = tm.decode_step(tp, t[:, 6:], cache, n + 1)
    P = tm.cfg.prefix_len
    got = torch.cat([lg[:, None], steps], dim=1)
    np.testing.assert_allclose(got.numpy(), full[:, P + 5:].detach().numpy(), **TOL)


def test_plain_kernel_calls(pair):
    """K1's plain version once a layer in a prefill, K4's once a layer in a
    ``forward`` and a ``prefill_flash`` (the card's launches are counted the
    same way in chip_smoke.py's phase 12)."""
    _, _, tm, tp = pair
    toks, lens, pe = inputs(tm.cfg)
    t, ln, x = torch.from_numpy(toks), torch.from_numpy(lens), torch.from_numpy(pe)
    nl = tm.cfg.n_layers
    with torch.no_grad():
        k1, k4 = ops.PLAIN.launches, ops.PLAIN_FLASH.launches
        tm.prefill(tp, t, tm.init_cache(2, CACHE_LEN, device="cpu"), ln, x)
        assert (ops.PLAIN.launches - k1, ops.PLAIN_FLASH.launches - k4) == (nl, 0)
        k1, k4 = ops.PLAIN.launches, ops.PLAIN_FLASH.launches
        tm.forward(tp, t, x)
        tm.prefill_flash(tp, t, tm.init_cache(2, CACHE_LEN, device="cpu"), ln, x)
        assert (ops.PLAIN.launches - k1, ops.PLAIN_FLASH.launches - k4) == (0, 2 * nl)


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def engines(pair):
    """The port's and JAX's engines on the same target and a small draft."""
    jm, jp, tm, tp = pair
    jd = dataclasses.replace(small_draft(JR, jm.cfg), dtype="float32")
    jeng = JEngine(jm.cfg, jd, max_new=MAX_NEW)
    dp_j = jeng.draft.init(jax.random.PRNGKey(1))
    teng = SpecDecodeEngine(tm.cfg, small_draft(TR, tm.cfg), max_new=MAX_NEW, device="cpu")
    return jeng, jp, dp_j, teng, tp, bridge.to_torch(jax.tree.map(np.asarray, dp_j), "cpu")


@pytest.fixture(scope="module")
def jax_greedy(engines):
    """JAX's greedy ``generate`` on the engine inputs."""
    jeng, jp, jdp, teng = engines[:4]
    toks, lens, pe = inputs(teng.tcfg, B=3, seed=3)
    out, _, _ = jeng.generate(jp, jdp, toks, lens, s=0, cache_len=CACHE_LEN,
                              target_extras={"prefix_embeds": jnp.asarray(pe)})
    return np.asarray(out)


def test_spec_equals_greedy_and_jax(engines, jax_greedy):
    """Greedy tokens equal JAX's ``generate`` on the same weights and
    prefixes; speculative tokens equal greedy ones at s 1 and 3 (the draft
    runs on the text alone, ``prefix_offset`` rows behind the target)."""
    teng, tp, tdp = engines[3:]
    assert teng.prefix_offset == teng.tcfg.prefix_len
    toks, lens, pe = inputs(teng.tcfg, B=3, seed=3)
    kw = {"prefix_embeds": pe}
    ref, _, _ = teng.generate(tp, tdp, toks, lens, s=0, cache_len=CACHE_LEN, target_extras=kw)
    np.testing.assert_array_equal(ref, jax_greedy)
    for s in (1, 3):
        out, _, _ = teng.generate(tp, tdp, toks, lens, s=s, cache_len=CACHE_LEN,
                                  target_extras=kw)
        np.testing.assert_array_equal(out, ref, err_msg=f"s={s}")


def _slot_pool(teng, tp, tdp, s, **geo):
    """The engine inputs admitted one by one into a 4-slot pool (slot 1
    never claimed), stepped at ``s`` until done; tokens by request."""
    toks, lens, pe = inputs(teng.tcfg, B=3, seed=3)
    state = teng.init_slots(4, CACHE_LEN, **geo)
    slots = ((2, 0), (0, 1), (3, 2))
    for slot, b in slots:
        state = teng.prefill_into(tp, tdp, state, slot, toks[b, :lens[b]], int(lens[b]),
                                  CACHE_LEN, {"prefix_embeds": pe[b:b + 1]})
    for _ in range(4 * MAX_NEW):
        state, _ = teng.step(tp, tdp, state, s)
        if bool(state.done.all()):
            break
    assert bool(state.done[1]) and int(state.n_generated[1]) == 0
    return np.stack([state.out[slot, :MAX_NEW].numpy() for slot, _ in slots]), state


@pytest.mark.parametrize("s", [0, 3])
def test_slot_pools_match_generate(engines, jax_greedy, s):
    """``prefill_into`` + steps on contiguous rings and on a paged pool of
    4-row blocks give JAX's greedy tokens, speculative or not; the paged
    slot's host rows count the prefix (``P + prompt`` at admission)."""
    teng, tp, tdp = engines[3:]
    ring, _ = _slot_pool(teng, tp, tdp, s)
    paged, state = _slot_pool(teng, tp, tdp, s, block_size=4)
    np.testing.assert_array_equal(ring, jax_greedy)
    np.testing.assert_array_equal(paged, jax_greedy)
    np.testing.assert_array_equal(state.seq_lens.numpy()[[2, 0, 3]],
                                  [state.paged.tokens(slot) for slot in (2, 0, 3)])


def test_reference_paged_vlm_fault_passes_on_the_port(engines, jax_greedy):
    """JAX's paged ``prefill_into`` allocates blocks for ``prompt_len`` rows
    (``src/repro/core/spec_decode.py:737``) while its prefill writes ``P +
    prompt_len - 1``: the rows past the blocks are dropped, and the
    steps' table growth, which counts from ``prompt_len``, leaves the
    first decode rows without a block.  Its paged pool's greedy tokens
    then part from its own ``generate``; the port's, which reserve ``P +
    prompt_len`` rows, equal it.  On this route the reference is not the
    oracle."""
    jeng, jp, jdp, teng, tp, tdp = engines
    toks, lens, pe = inputs(teng.tcfg, B=3, seed=3)
    state = jeng.init_slots(2, CACHE_LEN, block_size=4)
    state = jeng.prefill_into(jp, jdp, state, 0, toks[0, :lens[0]], int(lens[0]), CACHE_LEN,
                              {"prefix_embeds": jnp.asarray(pe[:1])})
    assert state.paged.tokens(0) == lens[0]            # the prefix's rows not counted
    for _ in range(2 * MAX_NEW):
        state, _ = jeng.step(jp, jdp, state, 0)
        if bool(np.asarray(state.done)[0]):
            break
    jax_paged = np.asarray(state.out)[0, :MAX_NEW]
    assert not np.array_equal(jax_paged, jax_greedy[0])
    port_paged, _ = _slot_pool(teng, tp, tdp, 0, block_size=4)
    np.testing.assert_array_equal(port_paged[0], jax_greedy[0])


# ---------------------------------------------------------------------------
# guards


def test_engine_needs_prefix_embeds(engines):
    """Without ``prefix_embeds`` the draft's lengths (the target's less the
    prefix) would go negative: ``generate`` and ``prefill_into`` raise."""
    teng, tp, tdp = engines[3:]
    toks, lens, _ = inputs(teng.tcfg, B=3, seed=3)
    with pytest.raises(ValueError, match="prefix_embeds"):
        teng.generate(tp, tdp, toks, lens, s=0, cache_len=CACHE_LEN)
    state = teng.init_slots(2, CACHE_LEN, block_size=4)
    with pytest.raises(ValueError, match="prefix_embeds"):
        teng.prefill_into(tp, tdp, state, 0, toks[0], int(lens[0]), CACHE_LEN)
    assert state.paged.tokens(0) == 0                   # nothing allocated


def test_chunked_prefill_and_prefix_cache_refuse(engines):
    """A chunk and a cached prefix carry no prefix embeddings."""
    teng, tp, tdp = engines[3:]
    state = teng.init_slots(2, CACHE_LEN, block_size=4)
    toks = np.arange(12, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        teng.prefill_chunk_into(tp, tdp, state, 0, toks[:8], 0, 8, 12)
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        teng.attach_prefix(tdp, state, 0, toks, 8, 12)


def test_continuous_runtime_and_launchers_refuse(engines):
    """As JAX's: the continuous runtime and the serving launcher carry no
    per-request extras; VLM training waits for K4's backward at hd 256."""
    teng, tp, tdp = engines[3:]
    with pytest.raises(NotImplementedError, match="modality extras"):
        ContinuousEngineBackend(teng, tp, tdp, capacity=2, cache_len=CACHE_LEN)
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        slaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--dtype", "float32"])
    with pytest.raises(NotImplementedError, match="head dim 256"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1"])


def test_k4_backward_at_head_dim_256_raises_before_any_launch():
    """K4's forward takes (256, 256); its backward does not, and says so
    before it checks or launches anything."""
    assert (256, 256) in K4.FWD_HEAD_DIMS and (256, 256) not in K4.HEAD_DIMS
    B, T, H, hd = 1, 8, 2, 256
    q = torch.zeros((B, T, H, hd))
    kv = torch.zeros((B, T, 1, hd))
    pos = torch.arange(T, dtype=torch.int32)[None]
    launches = K4.BWD.launches
    with pytest.raises(NotImplementedError, match="256"):
        K4.flash_attn_bwd_cuda(q, kv, kv, q, q, torch.zeros((B, H, T)), pos, pos)
    assert K4.BWD.launches == launches
