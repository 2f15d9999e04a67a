"""The port's dense decoder against the JAX ``DecoderLM``: the shared layers
function by function, and ``prefill`` + ``decode_step`` logits and caches on
the ``opt-6.7b`` and ``yi-9b`` smoke configs (yi covers GQA with two query
heads per kv-head), with the JAX weights carried over by ``bridge.py``.

fp32 throughout.  Tolerances: 1e-5 for the single layers (the same fp32
operations); 1e-4 for logits and caches after two decoder layers (matrix
products summed in another order by the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import common as jcm
from repro.models.transformer import DecoderLM as JDecoderLM
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.models import common as tcm
from repro_torch.models.transformer import DecoderLM
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["opt-6.7b", "yi-9b"]


def _pair(arch, **cfg_kw):
    jcfg = JR.get_smoke_config(arch)
    tcfg = TR.get_smoke_config(arch)
    if cfg_kw:
        jcfg = jcfg.with_(attn=dataclasses.replace(jcfg.attn, **cfg_kw))
        tcfg = tcfg.with_(attn=dataclasses.replace(tcfg.attn, **cfg_kw))
    jm, tm = JDecoderLM(jcfg), DecoderLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# layers


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    g = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(tcm.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                               np.asarray(jcm.rms_norm(jnp.asarray(x), jnp.asarray(g))),
                               **LAYER_TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(1)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32) * 0.2
                 for s in ((2, 4, 32), (32, 48), (32, 48)))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    want = np.asarray(jcm.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = tcm.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [40, 41, 42, 43, 44, 45, 46]], np.int32)
    want = np.asarray(jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    table = tcm.rope_table(torch.from_numpy(pos), 32, theta)
    np.testing.assert_array_equal(
        tcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, table).numpy(), got)


@pytest.mark.parametrize("window,prefix_len", [(None, 0), (3, 0), (None, 2), (4, 3)])
def test_position_mask_matches_jax(window, prefix_len):
    qp = np.array([[5, 6, -1], [2, 3, 4]], np.int32)
    kp = np.array([[0, 1, 2, 3, 4, 5, 6, -1], [7, 0, 1, 2, 3, -1, -1, -1]], np.int32)
    want = np.asarray(jcm.position_mask(jnp.asarray(qp), jnp.asarray(kp), window, prefix_len))
    got = tcm.position_mask(torch.from_numpy(qp), torch.from_numpy(kp), window, prefix_len)
    np.testing.assert_array_equal(got.numpy(), want)


def test_embed_unembed_match_jax():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((512, 32)).astype(np.float32)
    tok = np.array([[1, 5, 511], [0, 7, 300]], np.int32)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tcm.embed(torch.from_numpy(tok), torch.from_numpy(table)).numpy(),
        np.asarray(jcm.embed(jnp.asarray(tok), jnp.asarray(table))))
    want = np.asarray(jcm.unembed(jnp.asarray(x), jnp.asarray(table), 500))
    got = tcm.unembed(torch.from_numpy(x), torch.from_numpy(table), 500).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    assert (got[..., 500:] == -1e30).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax_layout(arch):
    """Same keys, same stacked shapes, and the JAX package's distributions."""
    jm, jp, tm, _ = _pair(arch)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
                   else tuple(v.shape)) for k, v in tp.items()}
    assert tshapes == jshapes
    d = tm.cfg.d_model
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002
    assert abs(float(tp["layers"]["wq"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert (tp["layers"]["attn_norm"] == 1).all() and (tp["final_norm"] == 1).all()
    again = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["w_up"], tp["layers"]["w_up"])


def test_bridge_round_trip_keeps_dtypes():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": {"c": np.ones((2,), np.float32)}}
    t = bridge.to_torch(tree, "cpu", dtype=torch.bfloat16)
    assert t["a"].dtype == torch.int32 and t["b"]["c"].dtype == torch.bfloat16
    back = bridge.to_numpy(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])


# ---------------------------------------------------------------------------
# the decoder


def _prefill_both(arch, B=3, P=12, L=40, seed=0, **cfg_kw):
    jm, jp, tm, tp = _pair(arch, **cfg_kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, P - 5, P - 3][:B], np.int32)
    jl, jc, jt = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jm.init_cache(B, L),
                                     jnp.asarray(lens))
    tl, tc, tt = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(B, L, device="cpu"),
                            torch.from_numpy(lens))
    return (jm, jp, jl, jc, jt), (tm, tp, tl, tc, tt), rng


def _assert_cache_equal(tc, jc):
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    (_, _, jl, jc, jt), (_, _, tl, tc, tt), _ = _prefill_both(arch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_equal(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, T):
    """Two decode steps after prefill: a verify-width feed, then one more."""
    (jm, jp, _, jc, jt), (tm, tp, _, tc, tt), rng = _prefill_both(arch, seed=T)
    seq = np.asarray(jt) + 1
    for _ in range(2):
        feed = rng.integers(0, jm.cfg.vocab_size, (3, T)).astype(np.int32)
        jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jc, jnp.asarray(seq))
        tl, tc = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(seq))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        _assert_cache_equal(tc, jc)
        seq = seq + T


def test_decode_step_wraps_the_ring_like_jax():
    """A cache shorter than the context: writes wrap modulo L and the
    overwritten rows stop being attended."""
    (jm, jp, _, jc, jt), (tm, tp, _, tc, tt), rng = _prefill_both("yi-9b", L=16)
    seq = np.asarray(jt) + 1
    for _ in range(4):
        feed = rng.integers(0, jm.cfg.vocab_size, (3, 3)).astype(np.int32)
        jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jc, jnp.asarray(seq))
        tl, tc = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(seq))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        seq = seq + 3
    _assert_cache_equal(tc, jc)


def test_sliding_window_matches_jax():
    (jm, jp, jl0, jc, jt), (tm, tp, tl0, tc, tt), rng = _prefill_both("opt-6.7b", window=5)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), **MODEL_TOL)
    feed = rng.integers(0, jm.cfg.vocab_size, (3, 4)).astype(np.int32)
    seq = np.asarray(jt) + 1
    jl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jc, jnp.asarray(seq))
    tl, _ = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(seq))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


def test_decoder_rejects_families_it_does_not_cover():
    cfg = TR.get_smoke_config("opt-6.7b").with_(family="hybrid")
    with pytest.raises(NotImplementedError):
        DecoderLM(cfg)


# ---------------------------------------------------------------------------
# prefill_flash: the prompt's attention by K4 (its plain version here)


def _flash_both(arch, B=3, P=12, L=40, seed=0, **cfg_kw):
    jm, jp, tm, tp = _pair(arch, **cfg_kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, P - 5, P - 3][:B], np.int32)
    jout = jax.jit(jm.prefill_flash)(jp, jnp.asarray(toks), jm.init_cache(B, L),
                                     jnp.asarray(lens))
    tout = tm.prefill_flash(tp, torch.from_numpy(toks), tm.init_cache(B, L, device="cpu"),
                            torch.from_numpy(lens))
    return (tm, tp, toks, lens), jout, tout


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("arch", ARCHS + ["internlm2-1.8b"])
def test_prefill_flash_matches_jax(arch, window):
    kw = {"window": window} if window else {}
    _, (jl, jc, jt), (tl, tc, tt) = _flash_both(arch, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_equal(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flash_matches_prefill(arch):
    """The same contract as ``prefill``: last-token logits, the positions
    and every cache row written with one (padded rows differ: ``prefill``
    lets them attend, ``prefill_flash`` masks them, and neither is read)."""
    (tm, tp, toks, lens), _, (tl, tc, tt) = _flash_both(arch, seed=3)
    pl, pc, pt = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(3, 40, device="cpu"),
                            torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), pl.numpy(), **MODEL_TOL)
    assert torch.equal(tc["pos"], pc["pos"]) and torch.equal(tt, pt)
    written = pc["pos"] >= 0
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key][:, written].numpy(), pc[key][:, written].numpy(),
                                   **MODEL_TOL)


def test_prefill_flash_takes_the_contiguous_ring_only():
    tm = DecoderLM(TR.get_smoke_config("yi-9b"))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    pool = tm.init_paged_cache(4, 8, device="cpu")
    pool["bt"] = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="contiguous ring only"):
        tm.prefill_flash(tp, torch.zeros((1, 4), dtype=torch.int32), pool)


def test_forward_rejects_modality_prefixes():
    """A text model (prefix_len 0) rejects prefix embeddings, and a VLM
    rejects a prefix of the wrong length, in each entry point that takes
    them (the VLM's own behaviour: tests/test_torch_vlm.py)."""
    tm = DecoderLM(TR.get_smoke_config("opt-6.7b"))
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="prefix_embeds"):
        tm.forward(tp, toks, prefix_embeds=torch.zeros((1, 1, tm.cfg.d_model)))
    vm = DecoderLM(TR.get_smoke_config("paligemma-3b"))
    vp = vm.init(torch.Generator().manual_seed(0), device="cpu")
    short = torch.zeros((1, vm.cfg.prefix_len - 1, vm.cfg.d_model))
    for entry in (vm.prefill, vm.prefill_flash):
        with pytest.raises(ValueError, match="prefix_embeds"):
            entry(vp, toks, vm.init_cache(1, 32, device="cpu"), prefix_embeds=short)
