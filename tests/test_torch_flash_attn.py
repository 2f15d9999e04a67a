"""The port's K4 (flash attention) and K5 (RMSNorm) on the CPU, i.e. their
plain versions, forward and backward, against the JAX package: the Pallas
kernels ``flash_attn_pallas`` / ``rmsnorm_pallas`` in interpret mode, the
JAX references (``ops.flash_attn(use_pallas=False)``), and ``jax.vjp`` of
the model functions ``flash_attention_train`` and ``rms_norm``.

Inputs are made with numpy from a seed and handed to both packages.  fp32
throughout.  Tolerances: 2e-5 absolute and relative for the attention
forward (the bound the JAX kernel tests use for the online softmax against
its reference), 1e-4 for its gradients (sums over the G query heads and all
key rows taken in another order), 1e-5 for RMSNorm and its gradients.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attn import flash_attn_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.models import common as jcm
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attn as K4
from repro_torch.kernels import rmsnorm as K5
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
NORM_TOL = dict(rtol=1e-5, atol=1e-5)

# (name, G, kwargs of the mask, lengths of the batch rows; -1 rows past them)
CASES = {
    "causal_g1": (1, {}, None),
    "causal_g2": (2, {}, None),
    "causal_g8": (8, {}, None),
    "window": (2, {"window": 5}, None),
    "prefix": (2, {"prefix_len": 4}, None),
    "window_prefix": (2, {"window": 4, "prefix_len": 3}, None),
    "padded_masked": (2, {}, [19, 0, 7]),
}


def _case(name, B=3, T=19, KVH=2, hd=16, seed=0):
    """Self-attention inputs as the training forward and ``prefill_flash``
    give them: positions 0..T-1, rows past a length at -1 (a length of 0
    masks every row of that batch entry)."""
    G, kw, lens = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, KVH * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, hd)).astype(np.float32)
    do = rng.standard_normal((B, T, KVH * G, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if lens is not None:
        pos = np.where(pos < np.array(lens)[:, None], pos, -1).astype(np.int32)
    return q, k, v, do, pos, kw


def _t(*xs, grad=False):
    return [torch.from_numpy(x).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("name", list(CASES))
def test_flash_forward_matches_jax(name):
    """The port's plain forward (with and without the logsumexp) against the
    Pallas kernel in interpret mode and the JAX reference."""
    q, k, v, _, pos, kw = _case(name)
    j = [jnp.asarray(x) for x in (q, k, v, pos, pos)]
    interp = np.asarray(jax.jit(functools.partial(jops.flash_attn, use_pallas=True,
                                                  block_q=8, block_k=8, **kw))(*j))
    jref = np.asarray(jops.flash_attn(*j, use_pallas=False, **kw))
    tq, tk, tv, tp = _t(q, k, v, pos)
    got = ops.flash_attn(tq, tk, tv, tp, tp, **kw).numpy()
    with_lse, lse = ref.flash_attn_fwd_lse_ref(tq, tk, tv, tp, tp, **kw)
    for want in (interp, jref):
        np.testing.assert_allclose(got, want, **FWD_TOL)
        np.testing.assert_allclose(with_lse.numpy(), want, **FWD_TOL)
    if not kw.get("prefix_len"):
        masked = pos < 0
        assert (got[masked] == 0).all()
        assert torch.isneginf(lse.permute(0, 2, 1)[torch.from_numpy(masked)]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_flash_backward_matches_jax_vjp(name):
    """The port's plain backward (``ops.flash_attn`` through autograd, which
    runs ``flash_attn_bwd_ref`` from the saved logsumexp) against ``jax.vjp``
    of the model's training attention."""
    q, k, v, do, pos, kw = _case(name, seed=1)
    jp = jnp.asarray(pos)
    _, vjp = jax.vjp(lambda a, b, c: jcm.flash_attention_train(a, b, c, jp, jp, block_q=8,
                                                               **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = _t(q, k, v, grad=True)
    tp, = _t(pos)
    out = ops.flash_attn(tq, tk, tv, tp, tp, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)
    if name == "padded_masked":     # a fully masked batch entry gets exact zeros
        assert all((g[1] == 0).all() for g in got)


def test_flash_explicit_backward_matches_autograd_of_the_plain_forward():
    """``flash_attn_bwd_ref`` (what the CUDA backward computes) equals
    autograd through ``gqa_masked_ref``, GQA with a window and padding."""
    q, k, v, do, pos, _ = _case("padded_masked", seed=2)
    tq, tk, tv = _t(q, k, v, grad=True)
    tp, = _t(pos)
    auto = torch.autograd.grad(ref.gqa_masked_ref(tq, tk, tv, tp, tp, window=6),
                               (tq, tk, tv), torch.from_numpy(do))
    out, lse = ref.flash_attn_fwd_lse_ref(tq, tk, tv, tp, tp, window=6)
    explicit = ref.flash_attn_bwd_ref(tq, tk, tv, out, torch.from_numpy(do), lse, tp, tp,
                                      window=6)
    for a, e in zip(auto, explicit):
        np.testing.assert_allclose(e.detach().numpy(), a.numpy(), **GRAD_TOL)


def test_flash_pallas_matches_ops_at_unaligned_rows():
    """K4's TPU kernel on folded inputs (one kv-head group, T not a multiple
    of the block) against the port's plain forward of the same rows."""
    rng = np.random.default_rng(3)
    B, T, hd = 2, 24, 16
    q, k, v = (rng.standard_normal((B, T, hd)).astype(np.float32) for _ in range(3))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    pos[1, 17:] = -1
    want = np.asarray(flash_attn_pallas(*map(jnp.asarray, (q, k, v, pos, pos)), block_q=8,
                                        block_k=8, interpret=True))
    got = ops.flash_attn(*_t(q[:, :, None], k[:, :, None], v[:, :, None]),
                         *_t(pos, pos))[:, :, 0]
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("shape", [(5, 64), (3, 4, 96)])
def test_rmsnorm_forward_matches_pallas_and_model(shape):
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    interp = np.asarray(rmsnorm_pallas(jnp.asarray(x), jnp.asarray(g), block_rows=4,
                                       interpret=True))
    model = np.asarray(jcm.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    got = ops.rmsnorm(*_t(x, g)).numpy()
    np.testing.assert_allclose(got, interp, **NORM_TOL)
    np.testing.assert_allclose(got, model, **NORM_TOL)


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_rmsnorm_backward_matches_jax_vjp(shape):
    """The port's plain backward (``rmsnorm_bwd_ref`` through ``ops.rmsnorm``)
    against ``jax.vjp`` of the model's ``rms_norm``, dx and dgamma."""
    rng = np.random.default_rng(5)
    x = (2 * rng.standard_normal(shape)).astype(np.float32)
    g = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(jcm.rms_norm, jnp.asarray(x), jnp.asarray(g))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    tx, tg = _t(x, g, grad=True)
    got = torch.autograd.grad(ops.rmsnorm(tx, tg), (tx, tg), torch.from_numpy(dy))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, **NORM_TOL)
    explicit = ref.rmsnorm_bwd_ref(*_t(x, g, dy))
    for a, e in zip(got, explicit):
        np.testing.assert_allclose(e.numpy(), a.numpy(), **NORM_TOL)


def test_rmsnorm_bf16_casts_before_gamma():
    """In bf16 the normalized row is rounded before the multiply by gamma, as
    the JAX model does: the plain version equals JAX's bf16 ``rms_norm``."""
    rng = np.random.default_rng(6)
    x = (3 * rng.standard_normal((4, 256))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = np.asarray(jcm.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16))
                      .astype(jnp.float32))
    got = ops.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)
    assert got.dtype == torch.bfloat16


def test_cpu_calls_run_the_plain_versions_only():
    """On CPU tensors neither kernel launches; each plain path counts one call
    per forward and one per backward, and none when no gradient is wanted."""
    q, k, v, do, pos, _ = _case("causal_g2")
    counts = lambda: (K4.FWD.launches, K4.BWD.launches, K5.FWD.launches,  # noqa: E731
                      K5.BWD.launches, ops.PLAIN_FLASH.launches, ops.PLAIN_RMSNORM.launches)
    c0 = counts()
    tq, tk, tv = _t(q, k, v, grad=True)
    tp, = _t(pos)
    torch.autograd.grad(ops.flash_attn(tq, tk, tv, tp, tp), (tq,), torch.from_numpy(do))
    x, = _t(q[0, :, 0], grad=True)
    gamma = torch.ones(q.shape[-1], requires_grad=True)
    torch.autograd.grad(ops.rmsnorm(x, gamma).sum(), (x, gamma))
    with torch.no_grad():
        ops.flash_attn(tq, tk, tv, tp, tp)
        ops.rmsnorm(x, gamma)
    c1 = counts()
    assert c1[:4] == c0[:4] == (0, 0, 0, 0)
    assert c1[4] == c0[4] + 3 and c1[5] == c0[5] + 3


@pytest.mark.parametrize("bad,match", [
    ("cpu_tensor", "CUDA device"), ("head_dim", "head dim"), ("dtype", "dtype"),
    ("pos_dtype", "int32"), ("window_zero", "window"), ("noncontig_heads", "contiguous")])
def test_flash_wrapper_rejects_what_it_cannot_take(bad, match):
    """K4's wrapper checks before any launch; what it cannot take raises."""
    q, k, v, _, pos, _ = _case("causal_g2", hd=64)
    tq, tk, tv, tp = _t(q, k, v, pos)
    kw = {}
    if bad == "head_dim":
        tq, tk, tv = (t[..., :48].contiguous() for t in (tq, tk, tv))
    elif bad == "dtype":
        tq, tk, tv = tq.double(), tk.double(), tv.double()
    elif bad == "pos_dtype":
        tp = tp.long()
    elif bad == "window_zero":
        kw["window"] = 0
    elif bad == "noncontig_heads":
        tk = tk.transpose(2, 3).contiguous().transpose(2, 3)
    launches = K4.FWD.launches, K4.BWD.launches
    with pytest.raises(ValueError, match=match):
        K4.flash_attn_fwd_cuda(tq, tk, tv, tp, tp, **kw)
    assert (K4.FWD.launches, K4.BWD.launches) == launches


@pytest.mark.parametrize("bad,match", [
    ("cpu_tensor", "CUDA device"), ("dtype", "dtype"), ("gamma", "gamma"),
    ("too_wide", "d <="), ("noncontig", "contiguous")])
def test_rmsnorm_wrapper_rejects_what_it_cannot_take(bad, match):
    x, g = torch.randn(4, 64), torch.ones(64)
    if bad == "dtype":
        x, g = x.double(), g.double()
    elif bad == "gamma":
        g = torch.ones(32)
    elif bad == "too_wide":
        x, g = torch.randn(2, K5.MAX_D + 1), torch.ones(K5.MAX_D + 1)
    elif bad == "noncontig":
        x = torch.randn(64, 4).T
    launches = K5.FWD.launches
    with pytest.raises(ValueError, match=match):
        K5.rmsnorm_fwd_cuda(x, g)
    assert K5.FWD.launches == launches


@pytest.mark.parametrize("name", ["flash_attn", "rmsnorm"])
def test_library_path_tracks_the_source(name):
    p = build.library_path(name)
    assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
    assert (build.CSRC / f"{name}.cu").is_file()


def test_default_scale_is_inverse_sqrt_head_dim():
    q, k, v, _, pos, _ = _case("causal_g2", seed=7)
    tq, tk, tv, tp = _t(q, k, v, pos)
    np.testing.assert_array_equal(
        ops.flash_attn(tq, tk, tv, tp, tp).numpy(),
        ops.flash_attn(tq, tk, tv, tp, tp, scale=1 / math.sqrt(q.shape[-1])).numpy())
