"""The qwen3 and yi-34b configs in the port against the JAX package, on the
CPU: qwen3-8b (Qwen3's per-head q/k RMSNorm, ``qk_norm``), yi-34b (seven
query heads per kv-head) and qwen3-moe-30b-a3b (``qk_norm`` and the MoE
block of ``models/moe.py``), on their smoke configs with the JAX weights
carried over by ``bridge.py``.

* the configs (full, smoke, draft) and the parameter trees;
* ``_qkv`` against JAX's ``_qkv_gqa``: the norms sit after the projections
  and before RoPE (normalising after RoPE gives other values);
* ``prefill``, ring ``decode_step`` (T 1 and 4), the paged ``decode_step``
  (with and without ``cu_blocks``, a table hole and an empty slot),
  ``prefill_chunk`` on a ring and on a paged pool, ``prefill_flash`` and
  ``forward`` with its aux loss, for the three configs; the MoE one also at
  capacity factor 1.0, where its dispatch drops assignments;
* the qwen3-8b mixed verify+chunk step (the packed dense layout) against
  JAX's ``decode_step_mixed``;
* speculative = greedy through the engine, and one training step against
  JAX's loss, gradients and ``make_train_step`` for qwen3-8b;
* K5's calls: four a layer with ``qk_norm``, two without.

The MoE-only tests (``moe_forward``, the mixed step at a capacity that
drops, the engine and the trainer) are in ``test_torch_moe.py``, which
reuses these helpers.

fp32 throughout.  Tolerances: ``MODEL_TOL`` (1e-4 absolute and relative)
for logits and caches after two decoder layers (matrix products summed in
another order by the two frameworks); ``LAYER_TOL`` (1e-5) for one layer's
q/k/v; the loss and aux 1e-5 relative; each gradient 1e-4 of its tensor's
largest entry; positions, tables and tokens exact.
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
from repro.training import optimizer as jopt
from repro.training import train_step as jstep
from repro_torch import bridge
from repro_torch.configs import registry as TR
from repro_torch.core.spec_decode import SpecDecodeEngine
from repro_torch.kernels import ops, tuning
from repro_torch.models import common as tcm
from repro_torch.models.transformer import DecoderLM
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MOE = "qwen3-moe-30b-a3b"
ARCHS = ["qwen3-8b", "yi-34b", MOE]
# every model-level case: the three smoke configs, and the MoE one at
# capacity factor 1.0, where its dispatch drops assignments
CASES = [(a, None) for a in ARCHS] + [(MOE, 1.0)]
CASE_IDS = ARCHS + [MOE + "-cf1"]


def _cfgs(arch, cf=None, **moe_kw):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    if cf is not None:
        moe_kw["capacity_factor"] = cf
    if moe_kw:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def pair(arch, cf=None, **moe_kw):
    """Both decoders on the JAX-initialised weights of a smoke config
    (``cf``/``moe_kw`` override the MoE config on both sides)."""
    jcfg, tcfg = _cfgs(arch, cf, **moe_kw)
    jm, tm = JDecoderLM(jcfg), DecoderLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def assert_cache_close(tc, jc, nb=None):
    """k/v within MODEL_TOL and positions equal; a paged pool is compared
    below the port's trash block (``nb``)."""
    rows = slice(None) if nb is None else slice(0, nb)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, rows], np.asarray(jc[key]), **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy()[rows], np.asarray(jc["pos"]))


def prefill_both(jm, jp, tm, tp, B=3, P=12, L=40, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, P - 5, P - 3][:B], np.int32)
    jl, jc, jt = jax.jit(jm.prefill)(jp, jnp.asarray(toks), jm.init_cache(B, L),
                                     jnp.asarray(lens))
    tl, tc, tt = tm.prefill(tp, torch.from_numpy(toks), tm.init_cache(B, L, device="cpu"),
                            torch.from_numpy(lens))
    return (jl, jc, jt), (tl, tc, tt), rng


NB, BLOCK, MAXB = 16, 8, 6


def paged_pool(tm, seed=0):
    """A pool as numpy: random K/V and garbage positions everywhere.  Slot 0
    holds positions 0..18 through [3, 7, 11]; slot 1 0..12 through
    [5, -1, 9], a hole over 8..15; slot 2 is empty (its table all -1)."""
    rng = np.random.default_rng(seed)
    a = tm.cfg.attn
    shape = (tm.cfg.n_layers, NB, BLOCK, a.n_kv_heads, a.head_dim)
    bt = np.full((3, MAXB), -1, np.int32)
    bt[0, :3] = [3, 7, 11]
    bt[1, :3] = [5, -1, 9]
    pos = rng.integers(0, 200, (NB, BLOCK)).astype(np.int32)
    for row, n in ((bt[0], 19), (bt[1], 13)):
        for j, pb in enumerate(row):
            if pb >= 0:
                rows = j * BLOCK + np.arange(BLOCK)
                pos[pb] = np.where(rows < n, rows, -1)
    return dict(k=(0.5 * rng.standard_normal(shape)).astype(np.float32),
                v=(0.5 * rng.standard_normal(shape)).astype(np.float32), pos=pos, bt=bt)


def port_pool(c):
    """The port's pool carries one trash block past the JAX pool's NB."""
    out = {"bt": torch.from_numpy(c["bt"].copy())}
    for name in ("k", "v"):
        out[name] = torch.from_numpy(
            np.concatenate([c[name], np.zeros_like(c[name][:, :1])], axis=1))
    out["pos"] = torch.from_numpy(np.concatenate([c["pos"], np.full_like(c["pos"][:1], -1)]))
    return out


def jax_pool(c):
    return {n: jnp.asarray(x) for n, x in c.items()}


def small_draft(registry, cfg):
    base = registry.get_draft_config(cfg.name.replace("-smoke", ""))
    return dataclasses.replace(
        base, n_layers=1, d_model=64, d_ff=128, vocab_size=cfg.vocab_size,
        attn=dataclasses.replace(base.attn, n_heads=2, n_kv_heads=2, head_dim=32))


def spec_equals_greedy(tcfg, s_values=(1, 3, 5)):
    """The port's engine on a smoke target with a small random draft:
    speculative tokens equal greedy ones at each s (JAX's own test)."""
    eng = SpecDecodeEngine(tcfg, small_draft(TR, tcfg), max_new=16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tp, dp = eng.target.init(gen, device="cpu"), eng.draft.init(gen, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    lens = np.array([10, 7, 9], np.int32)
    ref, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=96)
    for s in s_values:
        out, _, _ = eng.generate(tp, dp, toks, lens, s=s, cache_len=96)
        np.testing.assert_array_equal(out, ref, err_msg=f"{tcfg.name} s={s}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def assert_grads_close(got, want, rel=1e-4):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        scale = np.abs(w[k]).max()
        assert np.abs(g[k] - w[k]).max() <= rel * scale, (k, np.abs(g[k] - w[k]).max(), scale)


def train_step_matches_jax(arch, cf=None):
    """Loss, ce, aux and every gradient against ``jax.value_and_grad`` of
    JAX's loss; then one ``make_train_step`` step on both: its metrics
    (the updated parameters are not compared: Adam's first step moves each
    by about ``lr * sign(g)``, which flips where a gradient is near zero)."""
    jm, jp, tm, tp = pair(arch, cf)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jm.cfg.vocab_size, (3, 18)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, jm.cfg),
                                                has_aux=True))(jp, jbatch)
    tmet, tg = tstep.value_and_grad(tstep.make_loss_fn(tm, tm.cfg), tp, tbatch)
    assert set(tmet) == set(jmet)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    assert_grads_close(tg, jax.tree.map(np.asarray, jg))
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jnew, _, jm2 = jax.jit(jstep.make_train_step(jm, jm.cfg, opt))(
        jp, jopt.init_adamw(jp), jbatch)
    topt_cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tnew, _, tm2 = tstep.make_train_step(tm, tm.cfg, topt_cfg)(
        tp, topt.init_adamw(tp), tbatch)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm2[k]), float(jm2[k]), rtol=1e-5, err_msg=k)
    assert _flat(tnew).keys() == _flat(jax.tree.map(np.asarray, jnew)).keys()
    return float(tmet["aux"])


# ---------------------------------------------------------------------------
# configs and parameters


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for get in ("get_config", "get_smoke_config", "get_draft_config"):
        j, t = getattr(JR, get)(arch), getattr(TR, get)(arch)
        for f in ("name", "family", "n_layers", "d_model", "d_ff", "vocab_size", "norm_eps",
                  "source"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        for f in ("n_heads", "n_kv_heads", "head_dim", "qk_norm", "rope_theta", "window"):
            assert getattr(t.attn, f) == getattr(j.attn, f), (get, f)
        assert (t.moe is None) == (j.moe is None)
        if t.moe is not None:
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe), get
    assert TR.get_config(arch).attn.qk_norm == (arch != "yi-34b")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax_layout(arch):
    """Same nested keys and stacked shapes (``q_norm``/``k_norm`` and the
    MoE block's ``layers["moe"]`` under JAX's keys), ones for the norms."""
    jm, jp, tm, _ = pair(arch)
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == {
        k: v for k, v in _shapes(tp).items()}
    if tm.cfg.attn.qk_norm:
        assert (tp["layers"]["q_norm"] == 1).all() and (tp["layers"]["k_norm"] == 1).all()
    else:
        assert "q_norm" not in tp["layers"]
    assert isinstance(TR.build_model(tm.cfg), DecoderLM)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# q/k norms: after the projections, before RoPE


def test_qkv_matches_jax_norms_before_rope():
    jm, jp, tm, tp = pair("qwen3-8b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, tm.cfg.d_model)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [17, 18, 19, 20, 21]], np.int32)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = {k: v[1] for k, v in tp["layers"].items()}
    # gammas away from one, so that a norm's place shows
    g = rng.uniform(0.5, 1.5, (2, tm.cfg.attn.head_dim)).astype(np.float32)
    jlp = dict(jlp, q_norm=jnp.asarray(g[0]), k_norm=jnp.asarray(g[1]))
    tlp = dict(tlp, q_norm=torch.from_numpy(g[0]), k_norm=torch.from_numpy(g[1]))
    want = jm._qkv_gqa(jlp, jnp.asarray(x), jnp.asarray(pos))
    tpos = torch.from_numpy(pos)
    a = tm.cfg.attn
    got = tm._qkv(tlp, torch.from_numpy(x), tpos,
                  tcm.rope_table(tpos, a.head_dim, a.rope_theta))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **LAYER_TOL)
    # the norm after RoPE: another q
    d = tm.cfg.d_model
    q = (torch.from_numpy(x) @ tlp["wq"].reshape(d, -1)).view(2, 5, a.n_heads, a.head_dim)
    late = tcm.rms_norm(tcm.apply_rope(q, tpos, a.rope_theta), tlp["q_norm"])
    assert not np.allclose(late.numpy(), np.asarray(want[0]), **MODEL_TOL)


@pytest.mark.parametrize("arch,per_layer", [("qwen3-8b", 4), ("yi-34b", 2)])
def test_k5_calls_per_layer(arch, per_layer):
    """Every norm is one K5 call (its plain version here): attn and mlp norms,
    and the q and k norms under ``qk_norm``; one final norm."""
    _, _, tm, tp = pair(arch)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (2, 9)).astype(np.int32))
    ops.PLAIN_RMSNORM.launches = 0
    tm.prefill(tp, toks, tm.init_cache(2, 16, device="cpu"))
    assert ops.PLAIN_RMSNORM.launches == per_layer * tm.cfg.n_layers + 1


# ---------------------------------------------------------------------------
# the model entry points against JAX


@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_prefill_matches_jax(arch, cf):
    jm, jp, tm, tp = pair(arch, cf)
    (jl, jc, jt), (tl, tc, tt), _ = prefill_both(jm, jp, tm, tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert_cache_close(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_decode_step_matches_jax(arch, cf, T):
    """Two ring decode steps after prefill."""
    jm, jp, tm, tp = pair(arch, cf)
    (_, jc, jt), (_, tc, _), rng = prefill_both(jm, jp, tm, tp, seed=T)
    seq = np.asarray(jt) + 1
    for _ in range(2):
        feed = rng.integers(0, jm.cfg.vocab_size, (3, T)).astype(np.int32)
        jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jc, jnp.asarray(seq))
        tl, tc = tm.decode_step(tp, torch.from_numpy(feed), tc, torch.from_numpy(seq))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        assert_cache_close(tc, jc)
        seq = seq + T


@pytest.mark.parametrize("ragged", [False, True], ids=["dense", "cu_blocks"])
@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_paged_decode_step_matches_jax(arch, cf, ragged):
    """A T 4 verify on the pool of ``paged_pool``; the empty slot's rows go
    through every layer on both sides (they take MoE capacity too)."""
    jm, jp, tm, tp = pair(arch, cf)
    c = paged_pool(tm)
    seq = np.array([20, 14, 2], np.int32)
    feed = np.random.default_rng(6).integers(0, jm.cfg.vocab_size, (3, 4)).astype(np.int32)
    cu = tuning.host_cu_blocks(c["bt"]) if ragged else None
    jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(feed), jax_pool(c), jnp.asarray(seq),
                                     None if cu is None else jnp.asarray(cu))
    tl, tc = tm.decode_step(tp, torch.from_numpy(feed), port_pool(c), torch.from_numpy(seq),
                            None if cu is None else torch.from_numpy(cu))
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **MODEL_TOL)
    assert_cache_close(tc, jc, NB)
    np.testing.assert_array_equal(tc["bt"].numpy(), c["bt"])


@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_ring_prefill_chunk_matches_jax(arch, cf):
    """A chunk of 8 at offsets 9 and 4 of a prefilled ring, the second
    ragged (limit 9: its padded columns write nothing)."""
    jm, jp, tm, tp = pair(arch, cf)
    (_, jc, _), (_, tc, _), rng = prefill_both(jm, jp, tm, tp, P=9)
    toks = rng.integers(0, jm.cfg.vocab_size, (3, 8)).astype(np.int32)
    off, lim = np.array([9, 4, 7], np.int32), np.array([17, 9, 15], np.int32)
    jl, jc = jax.jit(jm.prefill_chunk)(jp, jnp.asarray(toks), jc, jnp.asarray(off),
                                       jnp.asarray(lim))
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), tc, torch.from_numpy(off),
                              torch.from_numpy(lim))
    valid = (off[:, None] + np.arange(8)[None]) < lim[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **MODEL_TOL)
    assert_cache_close(tc, jc)


@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_paged_prefill_chunk_matches_jax(arch, cf):
    """Slot 0 a ragged final chunk at 19..34 (5 real columns), slot 1 a
    chunk at 13..28 over the hole of its table, slot 2 a chunk of an empty
    table: everything it writes is dropped."""
    jm, jp, tm, tp = pair(arch, cf)
    c = paged_pool(tm)
    off, lim = np.array([19, 13, 0], np.int32), np.array([24, 29, 16], np.int32)
    toks = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, (3, 16)).astype(np.int32)
    cu = tuning.host_cu_blocks(c["bt"])
    jl, jc = jax.jit(jm.prefill_chunk)(jp, jnp.asarray(toks), jax_pool(c), jnp.asarray(off),
                                       jnp.asarray(lim), None, jnp.asarray(cu))
    tl, tc = tm.prefill_chunk(tp, torch.from_numpy(toks), port_pool(c), torch.from_numpy(off),
                              torch.from_numpy(lim), cu_blocks=torch.from_numpy(cu))
    valid = (off[:, None] + np.arange(16)[None]) < lim[:, None]
    valid[2] = False
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], **MODEL_TOL)
    assert_cache_close(tc, jc, NB)


@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_prefill_flash_matches_jax(arch, cf):
    jm, jp, tm, tp = pair(arch, cf)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 12)).astype(np.int32)
    lens = np.array([12, 8], np.int32)
    jl, jc, jt = jax.jit(jm.prefill_flash)(jp, jnp.asarray(toks), jm.init_cache(2, 40),
                                           jnp.asarray(lens))
    tl, tc, tt = tm.prefill_flash(tp, torch.from_numpy(toks),
                                  tm.init_cache(2, 40, device="cpu"), torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert_cache_close(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch,cf", CASES, ids=CASE_IDS)
def test_forward_and_aux_match_jax(arch, cf):
    jm, jp, tm, tp = pair(arch, cf)
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab_size, (3, 17)).astype(np.int32)
    jl, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tl, taux = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert taux.shape == () and taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == (tm.cfg.moe is not None)


# ---------------------------------------------------------------------------
# the mixed verify+chunk step: the packed layout of a dense model


def mixed_case(tm, seed=0):
    """The pool of ``paged_pool`` plus a fourth slot, pending, parked at 40,
    its host table row [2, 12, 6, 14, -1, -1] holding the prefix 0..15; its
    chunk covers 16..26 of a 16-column bucket."""
    c = paged_pool(tm, seed)
    host_row = np.array([2, 12, 6, 14, -1, -1], np.int32)
    for j, pb in enumerate(host_row[:2]):
        c["pos"][pb] = j * BLOCK + np.arange(BLOCK)
    c["bt"] = np.concatenate([c["bt"], np.full((1, MAXB), -1, np.int32)])
    return c, host_row, 16, 27


def mixed_both(arch, s, cf=None, tokens_wide=True, **moe_kw):
    """``decode_step_mixed`` on both packages (chunk slot 3), the port given
    the ``[B, Tm]`` tokens JAX takes or (``tokens_wide=False``) the verify
    columns alone, as its engine passes them; returns (JAX logits, JAX pool,
    port logits, port pool, pool, verify_len)."""
    jm, jp, tm, tp = pair(arch, cf, **moe_kw)
    c, host_row, start, limit = mixed_case(tm)
    CB, vl = 16, s + 1
    Tm = max(vl, CB)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab_size, (4, Tm)).astype(np.int32)
    toks[:, vl:] = 0                  # the engine's zero padding
    ctoks = rng.integers(0, tm.cfg.vocab_size, (CB,)).astype(np.int32)
    seq_lens = np.array([20, 14, 2, 40], np.int32)
    eff = c["bt"].copy()
    eff[3] = host_row
    cu = tuning.host_cu_blocks(eff)
    jl, jc = jax.jit(jm.decode_step_mixed, static_argnums=(9,))(
        jp, jnp.asarray(toks), jax_pool(c), jnp.asarray(seq_lens), jnp.int32(3),
        jnp.asarray(ctoks), jnp.int32(start), jnp.int32(limit), jnp.asarray(host_row), vl,
        jnp.asarray(cu))
    ttoks = toks if tokens_wide else toks[:, :vl]
    tl, tc = tm.decode_step_mixed(tp, torch.from_numpy(ttoks), port_pool(c),
                                  torch.from_numpy(seq_lens), 3, torch.from_numpy(ctoks),
                                  start, limit, torch.from_numpy(host_row), vl,
                                  torch.from_numpy(cu))
    return jl, jc, tl, tc, c, vl


@pytest.mark.parametrize("s", [0, 3])
def test_qwen3_mixed_step_matches_jax(s):
    """qwen3-8b keeps the packed dense layout (only real rows through the
    products); its verify logits and the pool equal JAX's."""
    jl, jc, tl, tc, c, vl = mixed_both("qwen3-8b", s, tokens_wide=False)
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3, :vl], **MODEL_TOL)
    assert_cache_close(tc, jc, NB)
    np.testing.assert_array_equal(tc["bt"].numpy(), c["bt"])


# ---------------------------------------------------------------------------
# the engine and the trainer


@pytest.mark.parametrize("arch", ["qwen3-8b", "yi-34b"])
def test_spec_equals_greedy(arch):
    spec_equals_greedy(TR.get_smoke_config(arch))


def test_qwen3_train_step_matches_jax():
    assert train_step_matches_jax("qwen3-8b") == 0.0


def test_engine_tokens_match_jax_on_qwen3():
    """The port's engine against JAX's on the same weights: tokens and
    per-step stats, qwen3-8b as its own draft at s 3 (everything accepted)."""
    jcfg, tcfg = JR.get_smoke_config("qwen3-8b"), TR.get_smoke_config("qwen3-8b")
    je = JEngine(jcfg, jcfg, max_new=10)
    te = SpecDecodeEngine(tcfg, tcfg, max_new=10, device="cpu")
    jt = jax.tree.map(np.asarray, JDecoderLM(jcfg).init(jax.random.PRNGKey(0)))
    tt = bridge.to_torch(jt, "cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    lens = np.array([10, 7, 9], np.int32)
    jout, jstats, _ = je.generate(jt, jt, toks, lens, s=3, cache_len=64, collect_stats=True)
    tout, tstats, _ = te.generate(tt, tt, toks, lens, s=3, cache_len=64, collect_stats=True)
    np.testing.assert_array_equal(tout, np.asarray(jout))
    assert len(tstats) == len(jstats)
    for a, b in zip(tstats, jstats):
        np.testing.assert_array_equal(a.accepted, b.accepted)
    assert sum(int(st.accepted.sum()) for st in tstats) > 0
