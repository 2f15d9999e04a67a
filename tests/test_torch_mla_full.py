"""MLA's full-sequence paths (DeepSeek-V2's ``forward`` for training and
``prefill_flash``) in the port against the JAX package, on the CPU.

Both expand the compressed ``ckv`` rows into per-head keys and values and
attend at q/k head dim ``head_dim + rope_head_dim`` and v head dim
``vdim``: 48 and 32 in the deepseek-v2-236b smoke config (2 layers, d 128,
4 heads, ``kv_lora_rank`` 32, ``q_lora_rank`` 48, 4 experts top-2 with a
shared one), 192 and 128 at full width, which is K4's (192, 128)
instantiation on the card.  Here K4's plain version carries them.  Weights
cross over through ``bridge.py``; inputs are made with numpy from a seed.

* ``forward``'s logits and MoE aux loss against JAX's ``forward`` (the
  smoke config, its full-rank q projection, MLA on the dense family);
* one train step: the loss and every gradient against
  ``jax.value_and_grad`` of JAX's loss, and ``make_train_step``'s metrics,
  at the smoke config's capacity factor (which drops) and at the no-drop
  factor;
* ``prefill_flash`` (logits, ``ckv``/``krope``/``pos`` rows, lengths)
  against JAX's with ragged prompts, and against the port's own
  ``prefill`` on the dense variant, where no capacity drop can couple the
  rows of a batch;
* the plain ``ops.flash_attn`` at dk 48, dv 32, forward and gradients,
  against ``flash_attention_tri`` and ``jax.vjp`` of
  ``flash_attention_train``, under the masks the model gives it;
* K4's calls a forward and a train step, and the training launcher.

fp32 throughout.  Tolerances: ``TOL`` (2e-5 absolute and relative) for
logits and cache rows after two layers, as ``test_torch_mla.py``; the
loss within 1e-5 relative; each gradient within 1e-4 of its tensor's
largest entry (``assert_grads_close``); the attention's outputs and
gradients within ``ATTN_TOL`` (1e-5).  Positions and lengths exact.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro.training import optimizer as jopt
from repro.training import train_step as jstep
from repro_torch.kernels import flash_attn as K4
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tstep
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_mla import ARCH, TOL, VARIANTS, assert_cache_close
from test_torch_mla import pair as _pair
from test_torch_qk_norm import assert_grads_close

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def pair(variant="q_lora", no_drop=False):
    """``test_torch_mla.pair``, built once a module; ``no_drop`` sets the
    capacity factor to n_experts / top_k on both sides."""
    jm, jp, tm, tp = _pair(variant)
    if no_drop and jm.cfg.moe is not None:
        def nd(cfg):
            return cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        jm, tm = type(jm)(nd(jm.cfg)), type(tm)(nd(tm.cfg))
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def jitted(variant, name, no_drop=False):
    """JAX's ``name`` entry point of a variant, compiled once a module."""
    jm = pair(variant, no_drop)[0]
    return jax.jit(getattr(jm, name))


def ragged(jm, B=3, T=13, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
    return toks, np.array([T, T - 6, T - 2][:B], np.int32)


# ---------------------------------------------------------------------------
# the training forward


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_aux_match_jax(variant):
    jm, jp, tm, tp = pair(variant)
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab_size, (3, 17)).astype(np.int32)
    jl, jaux = jitted(variant, "forward")(jp, jnp.asarray(toks))
    tl, taux = tm.forward(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert taux.shape == () and taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == (tm.cfg.moe is not None)


@pytest.mark.parametrize("no_drop", [False, True], ids=["smoke_cf", "no_drop"])
def test_train_step_matches_jax(no_drop):
    """Loss, ce, aux and every gradient (``w_uk``, ``w_uv``, ``w_krope``,
    the q-lora and kv norms among them) against ``jax.value_and_grad`` of
    JAX's loss; then one ``make_train_step`` step's metrics on both."""
    jm, jp, tm, tp = pair("q_lora", no_drop)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jm.cfg.vocab_size, (3, 18)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    (_, jmet), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jm, jm.cfg),
                                               has_aux=True))(jp, jbatch)
    tmet, tg = tstep.value_and_grad(tstep.make_loss_fn(tm, tm.cfg), tp, tbatch)
    assert set(tmet) == set(jmet)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    for name in ("w_uk", "w_uv", "w_krope", "q_norm", "kv_norm", "wq_a", "wq_b", "w_dkv"):
        assert name in tg["layers"], name
    assert_grads_close(tg, jax.tree.map(np.asarray, jg))
    opt = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    _, _, jm2 = jax.jit(jstep.make_train_step(jm, jm.cfg, opt))(jp, jopt.init_adamw(jp), jbatch)
    _, _, tm2 = tstep.make_train_step(tm, tm.cfg, topt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))(tp, topt.init_adamw(tp), tbatch)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm2[k]), float(jm2[k]), rtol=1e-5, err_msg=k)


def test_k4_calls_a_forward_and_a_train_step():
    """One K4 call a layer in the forward and one in the backward: the
    plain versions here (the kernel's counts do not move on the CPU)."""
    _, _, tm, tp = pair()
    toks = torch.zeros((2, 9), dtype=torch.int32)
    n = tm.cfg.n_layers
    k4 = K4.FWD.launches, K4.BWD.launches
    before = ops.PLAIN_FLASH.launches
    with torch.no_grad():
        tm.forward(tp, toks)
    assert ops.PLAIN_FLASH.launches - before == n
    before = ops.PLAIN_FLASH.launches
    tstep.value_and_grad(tstep.make_loss_fn(tm, tm.cfg), tp, {"tokens": toks})
    assert ops.PLAIN_FLASH.launches - before == 2 * n
    assert (K4.FWD.launches, K4.BWD.launches) == k4


def test_train_launcher_trains_mla():
    """The launcher's own step on the MLA smoke config: finite losses, and
    falling (the launcher asserts it, as JAX's does)."""
    res = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                        "--batch", "4", "--seq", "32", "--lr", "3e-3"])
    assert len(res["losses"]) == 3 and all(math.isfinite(x) for x in res["losses"])
    assert res["losses"][-1] < res["losses"][0]


# ---------------------------------------------------------------------------
# prefill_flash


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_flash_matches_jax(variant):
    jm, jp, tm, tp = pair(variant)
    toks, lens = ragged(jm, seed=4)
    jl, jc, jt = jitted(variant, "prefill_flash")(jp, jnp.asarray(toks), jm.init_cache(3, 40),
                                                  jnp.asarray(lens))
    before = ops.PLAIN_FLASH.launches
    tl, tc, tt = tm.prefill_flash(tp, torch.from_numpy(toks), tm.init_cache(3, 40, device="cpu"),
                                  torch.from_numpy(lens))
    assert ops.PLAIN_FLASH.launches - before == tm.cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, jc)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_prefill_flash_wraps_the_ring_as_jax_does():
    """A prompt longer than the ring: rows wrap modulo the ring's length,
    the later position winning, as JAX's scatter leaves them."""
    jm, jp, tm, tp = pair("dense")
    toks, lens = ragged(jm, B=2, T=13, seed=6)
    jl, jc, _ = jitted("dense", "prefill_flash")(jp, jnp.asarray(toks), jm.init_cache(2, 8),
                                                 jnp.asarray(lens))
    tl, tc, _ = tm.prefill_flash(tp, torch.from_numpy(toks), tm.init_cache(2, 8, device="cpu"),
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tc, jc)


def test_prefill_flash_agrees_with_prefill():
    """On the dense variant (no capacity to drop): the same last logits as
    the absorbed attention of ``prefill``, layer 0's ``ckv``/``krope`` rows
    bit for bit (the same projections of the same input), deeper rows
    within TOL, the same positions."""
    _, _, tm, tp = pair("dense")
    toks, lens = ragged(tm, seed=5)
    args = (tp, torch.from_numpy(toks))
    fl, fc, fs = tm.prefill_flash(*args, tm.init_cache(3, 40, device="cpu"),
                                  torch.from_numpy(lens))
    pl, pc, ps = tm.prefill(*args, tm.init_cache(3, 40, device="cpu"), torch.from_numpy(lens))
    V = tm.cfg.vocab_size
    np.testing.assert_allclose(fl[:, :V].numpy(), pl[:, :V].numpy(), **TOL)
    written = pc["pos"] >= 0
    for name in ("ckv", "krope"):
        assert torch.equal(fc[name][0][written], pc[name][0][written]), name
        np.testing.assert_allclose(fc[name][:, written].numpy(), pc[name][:, written].numpy(),
                                   **TOL)
    assert torch.equal(fc["pos"], pc["pos"]) and torch.equal(fs, ps)


# ---------------------------------------------------------------------------
# K4's plain version at MLA's head dims (dk 48, dv 32 here)


# name -> (B, T, H, KVH, lens, window, prefix_len)
ATTN_CASES = {
    "causal": (2, 24, 4, 4, None, None, 0),
    "padded": (3, 24, 4, 4, [24, 0, 11], None, 0),
    "window": (2, 24, 4, 4, None, 7, 0),
    "prefix_g2": (2, 24, 4, 2, None, None, 5),
}


def attn_inputs(name, dk=48, dv=32, seed=0):
    B, T, H, KVH, lens, window, prefix_len = ATTN_CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, T, H, dk), (B, T, KVH, dk), (B, T, KVH, dv), (B, T, H, dv)))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if lens is not None:
        pos = np.where(pos < np.array(lens)[:, None], pos, -1).astype(np.int32)
    return (q, k, v, do, pos), dict(window=window, prefix_len=prefix_len)


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_plain_flash_attn_at_mla_dims_matches_jax(name):
    """Forward against ``flash_attention_tri`` and ``flash_attention_train``
    at the model's explicit scale 1/sqrt(dk); gradients against
    ``jax.vjp`` of both: dq and dk of dk columns, dv of dv columns."""
    (q, k, v, do, pos), kw = attn_inputs(name)
    scale = 1.0 / math.sqrt(q.shape[-1])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tp = torch.from_numpy(pos)
    out = ops.flash_attn(tq, tk, tv, tp, tp, scale=scale, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert out.shape == do.shape
    assert [tuple(g.shape) for g in grads] == [q.shape, k.shape, v.shape]
    jp = jnp.asarray(pos)
    for fn in (functools.partial(jcm.flash_attention_tri, block_q=8, block_k=8),
               functools.partial(jcm.flash_attention_train, block_q=8)):
        want, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, jp, jp, scale=scale, **kw),  # noqa: B023
                            *(jnp.asarray(x) for x in (q, k, v)))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **ATTN_TOL)
        for g, w in zip(grads, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL)
    if name == "padded":
        assert bool((out[1] == 0).all()) and all(bool((g[1] == 0).all()) for g in grads)


def test_default_scale_is_inverse_sqrt_of_the_qk_dim():
    (q, k, v, _, pos), _ = attn_inputs("causal", seed=3)
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, pos))
    np.testing.assert_array_equal(
        ops.flash_attn(tq, tk, tv, tp, tp).numpy(),
        ops.flash_attn(tq, tk, tv, tp, tp, scale=1 / math.sqrt(48)).numpy())
