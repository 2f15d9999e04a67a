"""The port's Mamba-2 model against the JAX ``Mamba2LM`` on the mamba2-1.3b
smoke config, with the JAX weights carried over by ``bridge.py``: the
parameter tree and its layout, ``prefill`` with ragged prompts (one shorter
than ``d_conv``), ``decode_step`` logits and every checkpoint, ``commit`` at
mixed accept indices, and ``forward``; then the model's own contracts as
``tests/test_models_consistency.py`` states them for the JAX package
(stepwise decoding equals block decoding, rollback is exact, ``forward``
equals prefill + decode), the configs, and ``forward`` and the training
launcher under autograd (K6's backward).

fp32 throughout.  Tolerances: 1e-4 absolute and relative against JAX (two
layers of matrix products and scans summed in another order); 2e-3 for the
model's own contracts, the JAX package's bound for them (chunked against
recurrent summation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.transformer import DecoderLM
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "mamba2-1.3b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)
    jm, tm = JR.build_model(jcfg), TR.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _tokens(vocab, B=3, T=30, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, T)).astype(np.int32)


def _prefill_both(pair, lens):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, B=len(lens))
    jout = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(len(lens)), jnp.asarray(lens))
    tout = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(len(lens), device="cpu"),
                      torch.from_numpy(lens))
    return toks, jout, tout


def _close(t, j, tol=MODEL_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# against the JAX model


def test_param_tree_matches_jax_layout(pair):
    jm, jp, tm, _ = pair
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    jflat = dict(_flat(jax.tree.map(np.asarray, jp)))
    tflat = dict(_flat(tp))
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
    # the init's dt_bias and A_log are deterministic: equal in both packages
    for k in ("layers/dt_bias", "layers/A_log"):
        np.testing.assert_allclose(tflat[k].numpy(), jflat[k], rtol=1e-6, atol=1e-6)
    jc = jm.init_cache(2)
    tc = tm.init_cache(2, dtype=torch.bfloat16, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32 and tc["conv_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("lens", [[30, 30, 30], [30, 17, 2]], ids=["full", "ragged"])
def test_prefill_matches_jax(pair, lens):
    """Ragged prompts: dt is masked past each length, the conv buffers take
    the last valid rows and a prompt shorter than d_conv zeroes the rows
    before position 0."""
    _, (jl, jc, jn), (tl, tc, tn) = _prefill_both(pair, np.array(lens, np.int32))
    _close(tl, jl)
    for k in jc:
        _close(tc[k], jc[k])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    if lens[2] == 2:
        assert (tc["conv_x"][:, 2, 0] == 0).all()


@pytest.mark.parametrize("T", [1, 4])
def test_decode_step_and_checkpoints_match_jax(pair, T):
    jm, jp, tm, tp = pair
    lens = np.array([30, 17, 2], np.int32)
    _, (_, jc, _), (_, tc, _) = _prefill_both(pair, lens)
    feed = _tokens(jm.cfg.vocab_size, B=3, T=T, seed=1)
    jl, jco = jm.decode_step(jp, jnp.asarray(feed), jc, jnp.asarray(lens + 1))
    tl, tco = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(lens + 1))
    _close(tl, jl)
    assert sorted(tco) == sorted(jco)
    for k in jco:
        _close(tco[k], jco[k])


def test_commit_matches_jax_at_mixed_accept_indices(pair):
    """commit's gather equals the JAX one-hot sum, leaf by leaf."""
    jm, jp, tm, tp = pair
    lens = np.array([30, 17, 2], np.int32)
    _, (_, jc, _), (_, tc, _) = _prefill_both(pair, lens)
    feed = _tokens(jm.cfg.vocab_size, B=3, T=5, seed=2)
    _, jco = jm.decode_step(jp, jnp.asarray(feed), jc, jnp.asarray(lens + 1))
    _, tco = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(lens + 1))
    a = np.array([0, 4, 2], np.int32)
    jsel = jm.commit(jco, jnp.asarray(a))
    tsel = tm.commit(tco, torch.from_numpy(a))
    assert sorted(tsel) == sorted(jsel)
    for k in jsel:
        _close(tsel[k], jsel[k])
        onehot = (torch.arange(5)[None] == torch.from_numpy(a)[:, None]).float()
        ck = tco[k + "_ckpt"].float()
        want = (ck * onehot.reshape(1, 3, 5, *([1] * (ck.dim() - 3)))).sum(2)
        assert torch.equal(tsel[k].float(), want)


def test_forward_matches_jax(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(jm.cfg.vocab_size, B=2, T=24)
    jl, _ = jm.forward(jp, jnp.asarray(toks))
    before = ops.PLAIN_SSD.launches
    with torch.no_grad():
        tl, aux = tm.forward(tp, torch.from_numpy(toks))
    _close(tl, jl)
    assert float(aux) == 0.0
    assert ops.PLAIN_SSD.launches == before + tm.cfg.n_layers   # one scan per layer


# ---------------------------------------------------------------------------
# the model's own contracts (the engine convention: prefill p - 1 tokens)


def _committed(tm, tp, toks, p):
    cache = tm.init_cache(toks.shape[0], device="cpu")
    _, cache, n = tm.prefill(tp, torch.from_numpy(toks[:, :p - 1]), cache)
    return cache, n + 1


def test_forward_equals_prefill_then_decode(pair):
    _, _, tm, tp = pair
    B, T, p = 2, 24, 9
    toks = _tokens(tm.cfg.vocab_size, B=B, T=T, seed=4)
    with torch.no_grad():
        full, _ = tm.forward(tp, torch.from_numpy(toks))
    cache, n = _committed(tm, tp, toks, p)
    logits, _ = tm.decode_step(tp, torch.from_numpy(toks[:, p - 1:T - 1]), cache, n)
    _close(logits, full[:, p - 1:T - 1].numpy(), SELF_TOL)


def test_stepwise_decode_equals_block_decode(pair):
    """Token-by-token decoding with a commit at index 0 after each step
    equals one multi-token decode step: the checkpoints are exact."""
    _, _, tm, tp = pair
    B, T, p = 2, 20, 8
    toks = _tokens(tm.cfg.vocab_size, B=B, T=T, seed=5)
    feed = torch.from_numpy(toks[:, p - 1:T - 1])
    cache, n = _committed(tm, tp, toks, p)
    block, _ = tm.decode_step(tp, feed, cache, n)
    cache, n = _committed(tm, tp, toks, p)
    outs = []
    for i in range(feed.shape[1]):
        logits, out = tm.decode_step(tp, feed[:, i:i + 1], cache, n)
        outs.append(logits[:, 0])
        cache = tm.commit(out, torch.zeros((B,), dtype=torch.int32))
        n = n + 1
    _close(torch.stack(outs, 1), block.numpy(), SELF_TOL)


def test_commit_rollback_is_exact(pair):
    """Decode s + 1 positions with corrupt drafts, accept a = 1, and the
    next decode equals never having speculated."""
    _, _, tm, tp = pair
    B, T, p, s = 2, 22, 8, 4
    toks = _tokens(tm.cfg.vocab_size, B=B, T=T, seed=6)
    cache, n = _committed(tm, tp, toks, p)
    junk = toks[:, p - 1:p + s].copy()
    junk[:, 2:] = (junk[:, 2:] + 1) % tm.cfg.vocab_size
    _, out = tm.decode_step(tp, torch.from_numpy(junk), cache, n)
    cache = tm.commit(out, torch.ones((B,), dtype=torch.int32))
    n = n + 2
    ref, nr = _committed(tm, tp, toks, p)
    for i in range(2):
        _, out = tm.decode_step(tp, torch.from_numpy(toks[:, p - 1 + i:p + i]), ref, nr)
        ref = tm.commit(out, torch.zeros((B,), dtype=torch.int32))
        nr = nr + 1
    for k in ref:
        _close(cache[k], ref[k].numpy(), MODEL_TOL)
    feed = torch.from_numpy(toks[:, p + 1:T - 1])
    got, _ = tm.decode_step(tp, feed, cache, n)
    want, _ = tm.decode_step(tp, feed, ref, nr)
    _close(got, want.numpy(), SELF_TOL)


def test_forward_under_grad_raises_until_k6_has_a_backward(pair):
    """K6 has its backward now: ``forward`` under autograd no longer raises.
    It gives the no-grad forward's logits bit for bit (the same plain scan
    on the CPU, its Function around it), and a gradient reaches the
    parameters before the scan (``in_x``) and those of the decay (``A_log``,
    ``dt_bias``).  Modality prefixes still raise (item 12)."""
    _, _, tm, tp = pair
    toks = torch.from_numpy(_tokens(tm.cfg.vocab_size, B=1, T=16))
    layers = {k: v.clone().requires_grad_(k in ("in_x", "A_log", "dt_bias"))
              for k, v in tp["layers"].items()}
    grad_params = {**tp, "layers": layers}
    logits, _ = tm.forward(grad_params, toks)
    with torch.no_grad():
        want, _ = tm.forward(grad_params, toks)
    assert logits.shape == (1, 16, tm.padded_vocab) and torch.equal(logits, want)
    grads = torch.autograd.grad(logits[..., :tm.cfg.vocab_size].logsumexp(-1).sum(),
                                [layers[k] for k in ("in_x", "A_log", "dt_bias")])
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    with pytest.raises(NotImplementedError, match="item 12"):
        tm.forward(grad_params, toks, prefix_embeds=torch.zeros((1, 2, tm.cfg.d_model)))


def test_decode_step_rejects_a_block_table(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="block table"):
        tm.decode_step(tp, torch.zeros((1, 1), dtype=torch.int32),
                       tm.init_cache(1, device="cpu"), torch.ones(1, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# configs, the registry and the launchers


def test_configs_match_jax():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(JR, get)(ARCH), getattr(TR, get)(ARCH)
        for f in ("name", "family", "n_layers", "d_model", "vocab_size", "norm_eps"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    full = TR.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.ssm.d_state, full.ssm.chunk) == (48, 2048, 128, 256)
    assert Mamba2LM(full).nheads == 64


def test_dense_draft_matches_jax():
    """The draft of an SSM target inherits a 4096 window, as in JAX."""
    j, t = JR.get_draft_config(ARCH), TR.get_draft_config(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "d_ff", "vocab_size", "norm_eps"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("n_heads", "n_kv_heads", "head_dim", "rope_theta", "window"):
        assert getattr(t.attn, f) == getattr(j.attn, f), f
    assert t.attn.window == 4096
    assert TR.get_draft_config("yi-9b").attn.window is None


def test_build_model_picks_the_family():
    assert isinstance(TR.build_model(TR.get_smoke_config(ARCH)), Mamba2LM)
    assert isinstance(TR.build_model(TR.get_smoke_config("yi-9b")), DecoderLM)
    with pytest.raises(NotImplementedError, match="item 12"):
        TR.build_model(TR.get_smoke_config("yi-9b").with_(family="hybrid"))
    with pytest.raises(ValueError):
        Mamba2LM(TR.get_smoke_config("yi-9b"))


def test_train_launcher_raises_for_mamba2():
    """The launcher trained dense decoders only until K6 had its backward:
    it now builds the model by family (``registry.build_model``) and trains
    Mamba-2 without raising; the loss falls and the parameters are
    ``Mamba2LM``'s."""
    res = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "6",
                        "--batch", "4", "--seq", "32", "--lr", "3e-3"])
    assert res["losses"][-1] < res["losses"][0] and len(res["losses"]) == 6
    mparams = Mamba2LM(TR.get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0),
                                                      device="cpu")
    assert res["params"] == sum(t.numel() for _, t in _flat(mparams))
