"""The encoder-decoder family (seamless-m4t-large-v2) in the port against the
JAX package, on the CPU: the smoke config (2 encoder + 2 decoder layers, d
128, 4 heads of 32, vocabulary 512), with the JAX weights carried over by
``bridge.py`` and inputs made with numpy from a seed.

* the configs and the registry, the parameter trees (keys and shapes);
* ``encode`` with ragged ``src_lens`` (bidirectional: every query at
  position S, through K4's plain version), ``forward``'s logits,
  ``prefill``'s logits and every cache leaf (positions exact),
  ``decode_step`` at T 1 and T 4 after it, and decode against
  ``forward``'s rows at the same positions;
* a request whose ``src_lens`` is 0: its cross-attention row sees no key
  and takes the mean of ``xv`` (JAX's ``-1e30`` softmax), not zeros;
* the engine with ``target_extras``: greedy tokens against JAX's
  ``generate``, speculative = greedy at s 1, 3 and 5, and ``init_slots`` +
  ``prefill_into`` + steps against ``generate``;
* one train step's loss and gradients against ``jax.value_and_grad`` of
  JAX's loss; ten ``make_train_step`` steps at 24 encoder layers against
  JAX's, with frames drawn afresh each step and with one set; zero frames through 24 encoder layers overflowing the
  gradients on both packages; the training launcher;
* K4's plain-version calls (one a layer, encoder and decoder, in a
  forward and a prefill; none in a decode step); the guards of the
  continuous runtime and the serving launcher.

fp32 throughout.  Tolerance ``TOL`` (2e-5 absolute and relative) for
activations, logits and cache rows, as ``test_torch_mla_full.py``; the
loss within 1e-6 relative, each gradient within 1e-4 of its tensor's
largest entry; positions and tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core.spec_decode import SpecDecodeEngine as JEngine
from repro.models.encdec import EncDecLM as JEncDecLM
from repro.training import optimizer as jopt
from repro.training import train_step as jstep
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve as slaunch
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as tcm
from repro_torch.models.encdec import EncDecLM
from repro_torch.serving.scheduler import ContinuousEngineBackend
from repro_torch.training import AdamWConfig, DataConfig, batch_at
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_qk_norm import assert_grads_close, small_draft

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "seamless-m4t-large-v2"
S = 12            # source frames (JAX's own engine test uses 12)
CACHE_LEN = 40


@pytest.fixture(scope="module")
def pair():
    """Both models on the JAX-initialised weights of the smoke config."""
    jm, tm = JEncDecLM(JR.get_smoke_config(ARCH)), EncDecLM(TR.get_smoke_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def jitted(pair):
    """JAX's entry points, compiled once for the module."""
    jm = pair[0]
    return {name: jax.jit(getattr(jm, name))
            for name in ("encode", "forward", "prefill", "decode_step")}


def src(B, d, seed=7):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) * 0.1).astype(np.float32)


def both(x):
    """One numpy array as a JAX array and a CPU tensor."""
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **{**TOL, **kw})


# ---------------------------------------------------------------------------
# configs and parameters


def test_configs_match_jax():
    for get in ("get_config", "get_smoke_config", "get_draft_config"):
        j, t = getattr(JR, get)(ARCH), getattr(TR, get)(ARCH)
        for f in ("name", "family", "n_layers", "enc_layers", "cross_attn", "d_model",
                  "d_ff", "vocab_size", "norm_eps", "source", "dtype"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert dataclasses.asdict(t.attn) == {k: v for k, v in dataclasses.asdict(j.attn).items()
                                              if k in dataclasses.asdict(t.attn)}, get
    full = TR.get_config(ARCH)
    assert (full.enc_layers, full.n_layers, full.attn.head_dim, full.dtype) == (
        24, 24, 64, "bfloat16")
    assert isinstance(TR.build_model(full), EncDecLM)
    assert isinstance(TR.build_model(full.with_(family="encdec")), EncDecLM)
    with pytest.raises(NotImplementedError):
        TR.build_model(full.with_(family="hybrid"))


def test_param_trees_match_jax(pair):
    jm, jp, tm, tp = pair

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert shapes(own) == shapes(jp)
    assert set(own["dec"]) >= {"self_wq", "cross_wk", "self_norm", "cross_norm", "mlp_norm"}
    # the full size: 2,035,410,944 parameters (4.07 GB in bf16)
    full = EncDecLM(TR.get_config(ARCH)).param_defs()

    def count(defs, n):
        return sum(int(np.prod(d.full_shape(n))) for d in defs.values()
                   if isinstance(d, tcm.ParamDef))
    cfg = TR.get_config(ARCH)
    assert (count(full, 0) + count(full["enc"], cfg.enc_layers)
            + count(full["dec"], cfg.n_layers)) == 2_035_410_944


# ---------------------------------------------------------------------------
# the model's entry points


def test_encode_matches_jax(pair, jitted):
    """Ragged source lengths (one of them 0: K4's plain version and JAX's
    ``flash_attention_train`` both give that request's rows zeros)."""
    jm, jp, tm, tp = pair
    x = src(3, jm.cfg.d_model)
    lens = np.array([S, 7, 0], np.int32)
    (jx, tx), (jl, tl) = both(x), both(lens)
    jout, jpos = jitted["encode"](jp, jx, jl)
    tout, tpos = tm.encode(tp, tx, tl)
    close(tout, jout)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.dtype == torch.int32
    # no lengths: every frame valid
    close(tm.encode(tp, tx)[0], jitted["encode"](jp, jx)[0])


def test_forward_matches_jax(pair, jitted):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jm.cfg.vocab_size, (3, 15)).astype(np.int32)
    x, lens = src(3, jm.cfg.d_model), np.array([S, 5, 9], np.int32)
    jl, jaux = jitted["forward"](jp, jnp.asarray(toks), jnp.asarray(x), jnp.asarray(lens))
    tl, taux = tm.forward(tp, torch.from_numpy(toks), torch.from_numpy(x),
                          torch.from_numpy(lens))
    close(tl, jl)
    assert taux.shape == () and float(taux) == float(jaux) == 0.0


def prefill_both(pair, jitted, lens_src, B=3, T=13, seed=0):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
    plens = np.array([T, T - 6, T - 2][:B], np.int32)
    x = src(B, jm.cfg.d_model, seed + 1)
    srcl = np.asarray(lens_src, np.int32)
    jout = jitted["prefill"](jp, jnp.asarray(toks), jm.init_cache(B, CACHE_LEN, src_len=S),
                             jnp.asarray(plens), jnp.asarray(x), jnp.asarray(srcl))
    tout = tm.prefill(tp, torch.from_numpy(toks),
                      tm.init_cache(B, CACHE_LEN, device="cpu", src_len=S),
                      torch.from_numpy(plens), torch.from_numpy(x), torch.from_numpy(srcl))
    return jout, tout, toks, plens, x, srcl


def assert_cache_close(tc, jc):
    assert set(tc) == set(jc) == {"k", "v", "pos", "xk", "xv", "xpos"}
    for name in ("k", "v", "xk", "xv"):
        close(tc[name], jc[name], err_msg=name)
    for name in ("pos", "xpos"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


def test_prefill_matches_jax(pair, jitted):
    (jl, jc, jt), (tl, tc, tt), *_ = prefill_both(pair, jitted, [S, 8, 3])
    close(tl, jl)
    assert_cache_close(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_prefill_sizes_cross_leaves_from_the_source(pair):
    """A cache made for another source length gets cross leaves of S rows,
    as JAX's prefill replaces them."""
    _, _, tm, tp = pair
    toks = torch.zeros((2, 6), dtype=torch.int64)
    _, cache, _ = tm.prefill(tp, toks, tm.init_cache(2, CACHE_LEN, device="cpu", src_len=5),
                             src_embeds=torch.from_numpy(src(2, tm.cfg.d_model)))
    assert cache["xk"].shape[2] == cache["xv"].shape[2] == cache["xpos"].shape[1] == S
    with pytest.raises(ValueError):
        tm.prefill(tp, toks, tm.init_cache(2, CACHE_LEN, device="cpu"))


@pytest.mark.parametrize("T", [1, 4])
def test_decode_step_matches_jax(pair, jitted, T):
    jm, jp, tm, tp = pair
    (_, jc, jt), (_, tc, tt), *_ = prefill_both(pair, jitted, [S, 8, 3], seed=T)
    feed = np.random.default_rng(T).integers(0, jm.cfg.vocab_size, (3, T)).astype(np.int32)
    jl, jc2 = jitted["decode_step"](jp, jnp.asarray(feed), jc, jt + 1)
    tl, tc2 = tm.decode_step(tp, torch.from_numpy(feed), tc, tt + 1)
    close(tl, jl)
    assert_cache_close(tc2, jc2)


def test_decode_matches_forward(pair):
    """Decode after prefill gives ``forward``'s logits at the same positions
    (JAX's ``test_decode_matches_forward`` contract), prompt and source
    unpadded."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(4).integers(0, jm.cfg.vocab_size, (2, 10)).astype(np.int64)
    x = torch.from_numpy(src(2, tm.cfg.d_model, 4))
    full, _ = tm.forward(tp, torch.from_numpy(toks), x)
    P = 6
    lg, cache, n = tm.prefill(tp, torch.from_numpy(toks[:, :P]),
                              tm.init_cache(2, CACHE_LEN, device="cpu", src_len=S),
                              src_embeds=x)
    close(lg, full[:, P - 1].numpy())
    steps, _ = tm.decode_step(tp, torch.from_numpy(toks[:, P:]), cache, n + 1)
    close(steps, full[:, P:].numpy())


def test_fully_masked_cross_row_takes_the_mean_of_xv(pair, jitted):
    """``src_lens`` 0 for one request: its cross-attention sees no key.
    JAX's ``gqa_attention`` softmaxes scores masked to -1e30, which gives
    the row the mean of the value rows; the port's does the same (not K4's
    zeros).  Checked on the plain function and through a decode step."""
    q = torch.randn(1, 2, 4, 8, generator=torch.Generator().manual_seed(0))
    v = torch.randn(1, 5, 4, 8, generator=torch.Generator().manual_seed(1))
    mask = torch.zeros(1, 2, 5, dtype=torch.bool)
    out = tcm.gqa_attention(q, v, v, mask)
    close(out, v.mean(1, keepdim=True).expand(1, 2, 4, 8).numpy(), atol=1e-6)
    jm, jp, tm, tp = pair
    (_, jc, jt), (_, tc, tt), *_ = prefill_both(pair, jitted, [S, 0, 5], seed=3)
    assert (tc["xpos"][1] == -1).all()
    lp = {k: v[0] for k, v in tp["dec"].items()}
    hn = torch.randn(1, 1, tm.cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = tm._cross(lp, hn, tc["xk"][0, 1:2], tc["xv"][0, 1:2], tc["xpos"][1:2])
    want = tc["xv"][0, 1].mean(0).reshape(1, 1, -1) @ lp["cross_wo"].reshape(-1, tm.cfg.d_model)
    close(got, want.numpy(), atol=1e-6)
    feed = np.full((3, 1), 5, np.int32)
    jl, _ = jitted["decode_step"](jp, jnp.asarray(feed), jc, jt + 1)
    tl, _ = tm.decode_step(tp, torch.from_numpy(feed), tc, tt + 1)
    close(tl, jl)


def test_decode_step_refuses_a_paged_operand(pair):
    _, _, tm, tp = pair
    cache = tm.init_cache(1, CACHE_LEN, device="cpu", src_len=S)
    with pytest.raises(NotImplementedError):
        tm.decode_step(tp, torch.zeros((1, 1), dtype=torch.int64), cache,
                       torch.full((1,), 3, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))


def test_k4_calls_a_forward_a_prefill_and_a_decode(pair):
    """K4 (its plain version here) once a layer of each stack in a forward
    and a prefill, none in a decode step; a train step also runs each
    backward once a layer.  Each count is a difference of two readings."""
    _, _, tm, tp = pair
    c = tm.cfg
    n = c.enc_layers + c.n_layers
    toks = torch.zeros((2, 9), dtype=torch.int64)
    x = torch.from_numpy(src(2, c.d_model))
    before = ops.PLAIN_FLASH.launches
    with torch.no_grad():
        tm.forward(tp, toks, x)
    assert ops.PLAIN_FLASH.launches - before == n
    before = ops.PLAIN_FLASH.launches
    _, cache, lens = tm.prefill(tp, toks, tm.init_cache(2, CACHE_LEN, device="cpu", src_len=S),
                                src_embeds=x)
    assert ops.PLAIN_FLASH.launches - before == n
    before, k5 = ops.PLAIN_FLASH.launches, ops.PLAIN_RMSNORM.launches
    tm.decode_step(tp, toks[:, :4], cache, lens + 1)
    assert ops.PLAIN_FLASH.launches == before
    assert ops.PLAIN_RMSNORM.launches - k5 == 3 * c.n_layers + 1
    before = ops.PLAIN_FLASH.launches
    tstep.value_and_grad(tstep.make_loss_fn(tm, c, extra_keys=("src_embeds",)), tp,
                         {"tokens": toks, "src_embeds": x})
    assert ops.PLAIN_FLASH.launches - before == 2 * n


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def engines(pair):
    """The port's and JAX's engines on the same target and a small draft."""
    jm, jp, tm, tp = pair
    jd = dataclasses.replace(small_draft(JR, jm.cfg), dtype="float32")
    td = small_draft(TR, tm.cfg)
    jeng = JEngine(jm.cfg, jd, max_new=16)
    dp_j = jeng.draft.init(jax.random.PRNGKey(1))
    teng = SpecDecodeEngine(tm.cfg, td, max_new=16, device="cpu")
    return jeng, jp, dp_j, teng, tp, bridge.to_torch(jax.tree.map(np.asarray, dp_j), "cpu")


def engine_inputs(vocab, d, B=3):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, (B, 10)).astype(np.int32)
    return toks, np.array([10, 7, 9], np.int32)[:B], {"src_embeds": src(B, d)}


def test_spec_equals_greedy_and_jax(engines):
    """Greedy tokens equal JAX's ``generate`` on the same weights and
    source; speculative tokens equal greedy ones at s 1, 3 and 5 (JAX's
    ``test_spec_equals_greedy`` on the port's engine)."""
    jeng, jp, jdp, teng, tp, tdp = engines
    toks, lens, kw = engine_inputs(teng.tcfg.vocab_size, teng.tcfg.d_model)
    want, _, _ = jeng.generate(jp, jdp, toks, lens, s=0, cache_len=96,
                               target_extras={k: jnp.asarray(v) for k, v in kw.items()})
    ref, _, _ = teng.generate(tp, tdp, toks, lens, s=0, cache_len=96, target_extras=kw)
    np.testing.assert_array_equal(ref, np.asarray(want))
    for s in (1, 3, 5):
        out, _, _ = teng.generate(tp, tdp, toks, lens, s=s, cache_len=96, target_extras=kw)
        np.testing.assert_array_equal(out, ref, err_msg=f"s={s}")
    with pytest.raises(ValueError):
        teng.generate(tp, tdp, toks, lens, s=0, cache_len=96)


def test_slot_pool_matches_generate(engines):
    """``init_slots(src_len=S)`` + ``prefill_into`` of each request with its
    own source + s 3 steps give ``generate``'s tokens; ``xk``/``xv`` land
    on the slot axis 1 and ``xpos`` on axis 0."""
    _, _, _, teng, tp, tdp = engines
    toks, lens, kw = engine_inputs(teng.tcfg.vocab_size, teng.tcfg.d_model)
    ref, _, _ = teng.generate(tp, tdp, toks, lens, s=3, cache_len=64, target_extras=kw)
    state = teng.init_slots(4, 64, src_len=S)
    for slot, b in ((2, 0), (0, 1), (3, 2)):
        state = teng.prefill_into(tp, tdp, state, slot, toks[b, :lens[b]], int(lens[b]), 64,
                                  {"src_embeds": kw["src_embeds"][b:b + 1]})
        one = teng.prefill(tp, tdp, toks[b:b + 1, :lens[b]], lens[b:b + 1], 64,
                           {"src_embeds": kw["src_embeds"][b:b + 1]})
        for name in ("xk", "xv"):
            assert torch.equal(state.tcache[name][:, slot], one.tcache[name][:, 0]), name
        assert torch.equal(state.tcache["xpos"][slot], one.tcache["xpos"][0])
    for _ in range(40):
        state, _ = teng.step(tp, tdp, state, 3)
        if bool(state.done.all()):
            break
    out = state.out.numpy()
    for slot, b in ((2, 0), (0, 1), (3, 2)):
        np.testing.assert_array_equal(out[slot, :16], ref[b], err_msg=f"slot {slot}")
    assert bool(state.done[1])                      # never claimed


def test_continuous_runtime_refuses(engines):
    """JAX's guard: the continuous runtime's engine backend refuses a family
    whose requests need modality extras (admission does not carry them)."""
    _, _, _, teng, tp, tdp = engines
    with pytest.raises(NotImplementedError, match="modality extras"):
        ContinuousEngineBackend(teng, tp, tdp, capacity=2, cache_len=64)


def test_serving_launcher_refuses():
    """The serving launcher's profile and loop prefill without extras, as
    JAX's do: it refuses the family before building anything."""
    with pytest.raises(NotImplementedError, match="modality extras"):
        slaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--dtype", "float32"])


# ---------------------------------------------------------------------------
# training


def test_train_step_matches_jax(pair):
    """Loss and every gradient (both stacks, cross weights included)
    against ``jax.value_and_grad`` of JAX's loss with ``src_embeds``."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jm.cfg.vocab_size, (3, 18)).astype(np.int32),
             "src_embeds": src(3, jm.cfg.d_model, 11)}
    extra = ("src_embeds",)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jm, jm.cfg, extra_keys=extra), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tmet, tg = tstep.value_and_grad(tstep.make_loss_fn(tm, tm.cfg, extra_keys=extra), tp,
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-6, err_msg=k)
    assert set(tg["enc"]) == set(jg["enc"]) and set(tg["dec"]) == set(jg["dec"])
    assert_grads_close(tg, jax.tree.map(np.asarray, jg))


def test_ten_train_steps_match_jax_with_fresh_or_fixed_frames():
    """Ten ``make_train_step`` steps of the smoke widths at 24 encoder
    layers (the full config's depth) against JAX's, at the learning rate
    and schedule of the card's full-size trainer (lr 3e-4, warmup 2 of
    10): every step's loss within 1e-5 relative, with frames drawn afresh
    each step and with one set of frames for every step.  Afresh, the
    random encoder's output moves every step and the loss stays near
    ln(vocab) in both packages; one set lets it fall in both."""
    jcfg = JR.get_smoke_config(ARCH).with_(enc_layers=24)
    tcfg = TR.get_smoke_config(ARCH).with_(enc_layers=24)
    jm, tm = JEncDecLM(jcfg), EncDecLM(tcfg)
    jp0 = jm.init(jax.random.PRNGKey(0))
    extra = ("src_embeds",)
    jtrain = jax.jit(jstep.make_train_step(
        jm, jcfg, jopt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10), extra_keys=extra))
    ttrain = tstep.make_train_step(tm, tcfg, AdamWConfig(lr=3e-4, warmup_steps=2,
                                                         total_steps=10), extra_keys=extra)
    dc = DataConfig(vocab_size=tcfg.vocab_size, batch=4, seq_len=32, seed=0)
    curves = {}
    for fresh in (True, False):
        jp, tp = jp0, bridge.to_torch(jax.tree.map(np.asarray, jp0), "cpu")
        js, ts = jopt.init_adamw(jp), topt.init_adamw(tp)
        rng = np.random.default_rng(67)
        frames = rng.standard_normal((4, 8, tcfg.d_model)).astype(np.float32)
        jl, tl = [], []
        for i in range(10):
            if fresh and i:
                frames = rng.standard_normal((4, 8, tcfg.d_model)).astype(np.float32)
            toks = batch_at(dc, i)["tokens"]
            jp, js, jmet = jtrain(jp, js, {"tokens": jnp.asarray(toks),
                                           "src_embeds": jnp.asarray(frames)})
            tp, ts, tmet = ttrain(tp, ts, {"tokens": torch.from_numpy(toks),
                                           "src_embeds": torch.from_numpy(frames)})
            jl.append(float(jmet["loss"]))
            tl.append(float(tmet["loss"]))
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"fresh frames: {fresh}")
        curves[fresh] = np.asarray(jl)
    ln_v = np.log(tcfg.vocab_size)
    assert np.abs(curves[True] - ln_v).max() < 0.15, curves[True]
    assert curves[False][-1] < curves[False][0] - 0.2, curves[False]
    assert curves[False][-1] < curves[True][-1] - 0.1, curves


def test_zero_frames_overflow_a_deep_encoder_as_in_jax():
    """The launcher's zero frames through 24 encoder layers: every RMSNorm
    of a zero row scales the gradient by 1/sqrt(eps), so the encoder's
    gradients overflow, in JAX's reference as in the port (the loss stays
    finite); seeded frames keep them finite on both."""
    jcfg = JR.get_smoke_config(ARCH).with_(enc_layers=24)
    tcfg = TR.get_smoke_config(ARCH).with_(enc_layers=24)
    jm, tm = JEncDecLM(jcfg), EncDecLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    grad = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, jcfg, extra_keys=("src_embeds",)),
                                      has_aux=True))
    for frames, finite in ((np.zeros((2, 8, jcfg.d_model), np.float32), False),
                           (src(2, jcfg.d_model)[:, :8], True)):
        (jl, _), jg = grad(jp, {"tokens": jnp.asarray(toks), "src_embeds": jnp.asarray(frames)})
        tmet, tg = tstep.value_and_grad(
            tstep.make_loss_fn(tm, tcfg, extra_keys=("src_embeds",)), tp,
            {"tokens": torch.from_numpy(toks), "src_embeds": torch.from_numpy(frames)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jl), rtol=1e-6)
        assert all(bool(np.isfinite(np.asarray(g)).all())
                   for g in jax.tree.leaves(jg)) is finite
        assert all(bool(torch.isfinite(g).all()) for g in topt.leaves(tg)) is finite


def test_train_launcher_audio_branch():
    """``launch.train`` on the smoke config: zero ``src_embeds`` [batch, 8,
    d] as JAX's launcher gives them, the loss falling."""
    out = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "10",
                        "--batch", "4", "--seq", "64", "--log-every", "100"])
    assert out["arch"] == ARCH + "-smoke"
    assert out["losses"][-1] < out["losses"][0]
