"""K6's backward on the CPU: the plain backward ``ssd_chunked_bwd_ref`` (what
the CPU runs and what the card's kernel is held against) against torch
autograd through ``ssd_chunked_ref`` and against ``jax.vjp`` of the JAX
model's ``Mamba2LM._ssd_chunked``; ``ops.ssd_chunked`` under grad (the
``_SSDChunked`` Function, its launch counts, the no-grad path unchanged);
the backward's plan and workspace as plain functions of the shapes; the
CUDA wrapper through stand-ins for the card (what it hands the C entry, what
it refuses); and ``chip_smoke.ssd_bwd_bound``.

Inputs are made with numpy from a seed and handed to both packages.  The
plain backward runs in fp32.  Tolerances, each relative to the gradient's
largest entry: 1e-5 against torch autograd through ``ssd_chunked_ref`` run
in fp64, the exact value (fp32 autograd is no yardstick for dA: its
-sum dt dl route carries 1e-6 to 4e-5 of dA's largest entry in rounding,
which the plain backward's direct form of dA does not); 1e-4 against JAX
(the grads rule of the port's training tests: another framework's fp32
sums and exps, dA included).  The kernel's tensor-core arithmetic (three
tf32 products, its tiles and head slabs) is emulated in
``test_torch_ssd_bwd_numerics.py``.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as K6
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

AUTOGRAD_REL = 1e-5
JAX_REL = 1e-4
NAMES = ("dxh", "dB", "dC", "ddt", "dA", "dh0")


def _softplus(x):
    return np.log1p(np.exp(x))


def make_inputs(B, T, H, P, G, N, *, seed, h0=False, dh_final=False, strong=False,
                zero_rows=()):
    """xh, B, C, dt, A, h0 (or None), dy, dh_final (or None) as numpy fp32:
    conv-and-SiLU magnitudes, dt = softplus(noise + a bias of 1e-3 .. 1e-1
    over the heads), A = 1 .. 16 over the heads; ``strong``: dt 0.1 and A 16
    everywhere (cs falls to -1.6 a row); ``zero_rows``: rows of dt set to 0
    (padding)."""
    rng = np.random.default_rng(seed)
    silu = lambda v: v / (1 + np.exp(-v))  # noqa: E731
    xh = silu(rng.standard_normal((B, T, H, P))).astype(np.float32)
    Bm = silu(rng.standard_normal((B, T, G, N))).astype(np.float32)
    Cm = silu(rng.standard_normal((B, T, G, N))).astype(np.float32)
    bias = np.log(np.expm1(np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))))
    dt = _softplus(0.5 * rng.standard_normal((B, T, H)) + bias).astype(np.float32)
    A = np.linspace(1.0, 16.0, H).astype(np.float32)
    if strong:
        dt[:], A[:] = 0.1, 16.0
    for r in zero_rows:
        dt[:, r] = 0.0
    hinit = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32) if h0 else None
    dy = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dhf = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32) if dh_final else None
    return xh, Bm, Cm, dt, A, hinit, dy, dhf


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (name, B, T, H, P, G, N, chunk, options)
CASES = [
    ("chunks4_g1_h0_dhf", 2, 32, 4, 8, 1, 16, 8, dict(h0=True, dh_final=True)),
    ("chunks4_g1_zero", 2, 32, 4, 8, 1, 16, 8, {}),
    ("chunks4_g2_h0", 2, 32, 4, 8, 2, 16, 8, dict(h0=True)),
    ("chunks4_g2_dhf", 1, 32, 8, 16, 2, 8, 8, dict(dh_final=True)),
    ("one_chunk_g1_h0_dhf", 2, 16, 4, 8, 1, 16, 16, dict(h0=True, dh_final=True)),
    ("one_chunk_g4_zero", 1, 16, 8, 8, 4, 16, 32, {}),
    ("ragged_q3", 1, 21, 4, 8, 1, 16, 8, dict(h0=True)),            # Q 7: 3 chunks of 7
    ("dt_zero_rows", 2, 32, 4, 8, 1, 16, 8, dict(dh_final=True, zero_rows=(0, 5, 31))),
    ("strong_decay", 2, 32, 4, 8, 1, 16, 8, dict(strong=True, h0=True, dh_final=True)),
]


def _autograd(xh, Bm, Cm, dt, A, hinit, dy, dhf, chunk):
    """torch autograd through ``ssd_chunked_ref`` in fp64: the exact
    gradients of the same inputs."""
    f64 = lambda a: torch.from_numpy(a.astype(np.float64))  # noqa: E731
    leaves = [f64(a).requires_grad_(True) for a in (xh, Bm, Cm, dt, A)]
    hl = None if hinit is None else f64(hinit).requires_grad_(True)
    h0 = hl if hl is not None else torch.zeros((xh.shape[0], xh.shape[2], xh.shape[3],
                                                Bm.shape[3]), dtype=torch.float64)
    y, hf = ref.ssd_chunked_ref(*leaves, h0, chunk)
    assert y.dtype == torch.float64
    loss = (y * f64(dy)).sum()
    if dhf is not None:
        loss = loss + (hf * f64(dhf)).sum()
    grads = torch.autograd.grad(loss, leaves + ([hl] if hl is not None else []))
    return list(grads) + ([None] if hl is None else [])


def _assert_rel(got, want, rel, names=NAMES):
    for n, g, w in zip(names, got, want):
        if w is None:
            assert g is None, n
            continue
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (n, g.shape, w.shape)
        assert np.isfinite(g).all(), n
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= rel * scale, (n, np.abs(g - w).max(), scale)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd(case):
    _, B, T, H, P, G, N, chunk, opt = case
    xh, Bm, Cm, dt, A, hinit, dy, dhf = make_inputs(B, T, H, P, G, N, seed=T + H, **opt)
    got = ref.ssd_chunked_bwd_ref(*(_t(a) for a in (xh, Bm, Cm, dt, A, hinit)), chunk,
                                  _t(dy), _t(dhf))
    want = _autograd(xh, Bm, Cm, dt, A, hinit, dy, dhf, chunk)
    _assert_rel([None if g is None else g.numpy() for g in got],
                [None if w is None else w.numpy() for w in want], AUTOGRAD_REL)
    assert got[0].dtype == got[1].dtype == torch.float32 and got[4].shape == (H,)


def _jax_vjp(xh, Bm, Cm, dt, A, hinit, dy, dhf, chunk):
    """jax.vjp of the JAX model's ``_ssd_chunked`` (a zero h0 where None),
    with A = exp(A_log): returns the gradients with dA = dA_log / A."""
    cfg = JR.get_smoke_config("mamba2-1.3b")
    jm = JR.build_model(cfg.with_(ssm=cfg.ssm.__class__(**{**cfg.ssm.__dict__,
                                                          "chunk": chunk})))
    B, T, H, P = xh.shape
    N = Bm.shape[3]
    h0 = hinit if hinit is not None else np.zeros((B, H, P, N), np.float32)

    def f(xh_, b_, c_, dt_, alog, h_):
        return jm._ssd_chunked({"A_log": alog}, xh_, b_, c_, dt_, h_)

    args = [jnp.asarray(a) for a in (xh, Bm, Cm, dt, np.log(A), h0)]
    (y, hf), vjp = jax.vjp(f, *args)
    ct_h = jnp.asarray(dhf) if dhf is not None else jnp.zeros_like(hf)
    g = [np.asarray(v) for v in vjp((jnp.asarray(dy), ct_h))]
    g[4] = g[4] / A
    return g[:5] + [g[5] if hinit is not None else None]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax(case):
    _, B, T, H, P, G, N, chunk, opt = case
    xh, Bm, Cm, dt, A, hinit, dy, dhf = make_inputs(B, T, H, P, G, N, seed=T + H, **opt)
    got = ref.ssd_chunked_bwd_ref(*(_t(a) for a in (xh, Bm, Cm, dt, A, hinit)), chunk,
                                  _t(dy), _t(dhf))
    want = _jax_vjp(xh, Bm, Cm, dt, A, hinit, dy, dhf, chunk)
    _assert_rel([None if g is None else g.numpy() for g in got], want, JAX_REL)


def test_strong_decay_gradients_are_finite_at_a_full_chunk():
    """256 rows at A 16 and dt 0.1: cs reaches -410, where exp(cs_i) and
    exp(cs_Q - cs_j) underflow to 0 and exp(-cs_j) alone would overflow;
    every gradient stays finite, and dA (its direct form) stays within 1e-5
    of its largest entry where -sum dt dl in fp32 drifts to 4e-5."""
    xh, Bm, Cm, dt, A, hinit, dy, dhf = make_inputs(1, 512, 2, 8, 1, 8, seed=3, strong=True,
                                                    h0=True, dh_final=True)
    got = ref.ssd_chunked_bwd_ref(*(_t(a) for a in (xh, Bm, Cm, dt, A, hinit)), 256,
                                  _t(dy), _t(dhf))
    assert all(torch.isfinite(g).all() for g in got)
    want = _autograd(xh, Bm, Cm, dt, A, hinit, dy, dhf, 256)
    _assert_rel([g.numpy() for g in got], [w.numpy() for w in want], AUTOGRAD_REL)


def test_bf16_inputs_give_gradients_in_their_dtype():
    """bf16 xh, B and C: the plain backward computes in fp32 and returns
    dxh, dB and dC in bf16 (as autograd of the plain forward does), ddt, dA
    and dh0 in fp32, within bf16 rounding of the fp32 backward."""
    xh, Bm, Cm, dt, A, hinit, dy, dhf = make_inputs(2, 32, 4, 8, 1, 16, seed=9, h0=True)
    bf = [torch.from_numpy(a).bfloat16() for a in (xh, Bm, Cm)]
    got = ref.ssd_chunked_bwd_ref(*bf, _t(dt), _t(A), _t(hinit), 8, _t(dy), None)
    f32 = ref.ssd_chunked_bwd_ref(*(b.float() for b in bf), _t(dt), _t(A), _t(hinit), 8,
                                  _t(dy), None)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 3
    for g, w in zip(got, f32):
        assert torch.allclose(g.float(), w, rtol=1e-2, atol=1e-2 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# ops.ssd_chunked under grad: the _SSDChunked Function on the CPU


def test_ops_under_grad_counts_the_plain_forward_and_backward():
    xh, Bm, Cm, dt, A, hinit, dy, dhf = make_inputs(2, 32, 4, 8, 1, 16, seed=11, h0=True)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xh, Bm, Cm, dt, A, hinit)]
    before, k6 = ops.PLAIN_SSD.launches, (K6.KERNEL.launches, K6.KERNEL_BWD.launches)
    y, hf = ops.ssd_chunked(*leaves, 8)
    assert ops.PLAIN_SSD.launches == before + 1
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    assert ops.PLAIN_SSD.launches == before + 2
    assert (K6.KERNEL.launches, K6.KERNEL_BWD.launches) == k6
    # the unused final state's gradient reaches the backward as None (zero)
    want = ref.ssd_chunked_bwd_ref(*(_t(a) for a in (xh, Bm, Cm, dt, A, hinit)), 8, _t(dy))
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    with torch.no_grad():
        y0, h0_ = ops.ssd_chunked(*(_t(a) for a in (xh, Bm, Cm, dt, A, hinit)), 8)
    assert ops.PLAIN_SSD.launches == before + 3
    assert torch.equal(y0, y.detach()) and torch.equal(h0_, hf.detach())


def test_ops_under_grad_takes_the_final_state_gradient_and_a_zero_h0():
    """A loss on h_final hands its gradient to the backward; with h0 None no
    gradient is returned for it, and the others match the plain backward."""
    xh, Bm, Cm, dt, A, _, dy, dhf = make_inputs(1, 24, 4, 8, 2, 8, seed=12, dh_final=True)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xh, Bm, Cm, dt, A)]
    y, hf = ops.ssd_chunked(*leaves, None, 8)
    loss = (y * torch.from_numpy(dy)).sum() + (hf * torch.from_numpy(dhf)).sum()
    grads = torch.autograd.grad(loss, leaves)
    want = ref.ssd_chunked_bwd_ref(*(_t(a) for a in (xh, Bm, Cm, dt, A)), None, 8, _t(dy),
                                   _t(dhf))
    assert want[5] is None
    _assert_rel([g.numpy() for g in grads], [w.numpy() for w in want[:5]], 1e-6)


def test_no_grad_path_is_unchanged():
    """Without a gradient (or with no input that wants one) ssd_chunked is
    the forward-only call: one plain count, no Function node."""
    xh, Bm, Cm, dt, A, _, _, _ = make_inputs(1, 16, 4, 8, 1, 8, seed=13)
    before = ops.PLAIN_SSD.launches
    y, h = ops.ssd_chunked(*(_t(a) for a in (xh, Bm, Cm, dt, A)), None, 8)
    assert y.grad_fn is None and h.grad_fn is None
    assert ops.PLAIN_SSD.launches == before + 1


# ---------------------------------------------------------------------------
# the backward's plan, workspace and device kernels: plain functions of shapes


@pytest.mark.parametrize("B,T,H,G,P,N,Q,h0,tiles,hb,kernels", [
    (4, 512, 64, 1, 64, 128, 256, False, 4, 4, 6),     # the mamba2-1.3b trainer's call
    (2, 256, 64, 1, 64, 128, 256, False, 4, 1, 5),     # one chunk, a zero state
    (4, 256, 64, 1, 64, 128, 256, True, 4, 2, 6),      # one chunk with an h0
    (2, 300, 64, 1, 64, 128, 150, False, 3, 1, 6),
    (2, 24, 8, 1, 32, 16, 8, True, 1, 1, 6),           # the smoke widths
    (1, 257, 64, 1, 64, 128, 1, False, 1, 4, 6),
    (1, 512, 64, 8, 64, 128, 256, False, 4, 1, 6),     # 8 heads a group, 512 blocks at 1
    (4, 2048, 64, 64, 64, 128, 256, False, 4, 1, 6),   # a head a group
    (16, 512, 12, 2, 128, 64, 256, True, 4, 2, 6),     # 6 heads a group, the wide build
])
def test_bwd_plan_is_a_function_of_shapes(B, T, H, G, P, N, Q, h0, tiles, hb, kernels):
    """Key and query blocks per (batch, chunk, head slab, 64-row tile), the
    S role's bands of 4 row tiles per (batch, chunk, group), the states of
    dh per (batch, chunk, head) (two column splits past P 64) only with
    several chunks or an h0; five device kernels a call, six with the
    reverse carry."""
    plan = K6.ssd_bwd_plan(B, T, H, G, P, N, Q, h0)
    nc = T // Q
    assert plan["tiles"] == tiles == math.ceil(Q / K6.BWD_TILE)
    assert plan["heads_per_block"] == hb and (H // G) % hb == 0
    # the most heads a block that keeps 512 key blocks
    assert hb == 1 or plan["key_blocks"] >= 512
    assert hb == 4 or (H // G) % (2 * hb) or B * nc * tiles * H // (2 * hb) < 512
    assert plan["key_blocks"] == plan["query_blocks"] == B * nc * (H // hb) * tiles
    assert plan["s_blocks"] == B * nc * G * math.ceil(math.ceil(Q / 16) / 4)
    assert plan["finish_blocks"] == B * nc * H
    assert plan["state_blocks"] == (B * nc * H * (1 if P <= 64 else 2) if nc > 1 or h0 else 0)
    assert plan["reduce_blocks"] == math.ceil(B * T * G * N / 256) + 1
    assert plan["device_kernels"] == kernels == K6.ssd_bwd_device_kernels(nc, h0)


def _r4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("args,plan_over,want", [
    # the trainer's call: dh states and decays, S once (one group, 256 x 256),
    # L o D o dt of 10 tile pairs a head, db/dc per slab of 4 heads, four row
    # values, dA's parts of each key tile (4) and of each chunk
    ((4, 512, 64, 1, 64, 128, 256), {},
     4 * 2 * 64 * 64 * 128 + 4 * 2 * 64 + 4 * 2 * 256 * 256 + 4 * 2 * 64 * 10 * 64 * 64
     + 2 * 4 * 512 * 16 * 128 + 4 * 4 * 512 * 64 + 4 * 2 * 64 * 4 + 4 * 2 * 64),
    # one chunk and no h0: no states; 512 key blocks at a head a block
    ((2, 256, 64, 1, 64, 128, 256), {},
     2 * 256 * 256 + 2 * 64 * 10 * 64 * 64 + 2 * 2 * 256 * 64 * 128 + 4 * 2 * 256 * 64
     + 2 * 64 * 4 + 2 * 64),
    ((2, 256, 64, 1, 64, 128, 256, True), {},
     2 * 64 * 64 * 128 + 2 * 64 + 2 * 256 * 256 + 2 * 64 * 10 * 64 * 64
     + 2 * 2 * 256 * 64 * 128 + 4 * 2 * 256 * 64 + 2 * 64 * 4 + 2 * 64),
    # Q 150: three tiles, six pairs, S 160 x 160
    ((2, 300, 64, 1, 64, 128, 150), {},
     2 * 2 * 64 * 64 * 128 + 2 * 2 * 64 + 2 * 2 * 160 * 160 + 2 * 2 * 64 * 6 * 64 * 64
     + 2 * 2 * 300 * 64 * 128 + 4 * 2 * 300 * 64 + 2 * 2 * 64 * 3 + 2 * 2 * 64),
    # a plan forced to a head a block: db/dc partials per head
    ((4, 512, 64, 1, 64, 128, 256), dict(heads_per_block=1),
     4 * 2 * 64 * 64 * 128 + 4 * 2 * 64 + 4 * 2 * 256 * 256 + 4 * 2 * 64 * 10 * 64 * 64
     + 2 * 4 * 512 * 64 * 128 + 4 * 4 * 512 * 64 + 4 * 2 * 64 * 4 + 4 * 2 * 64),
    # the smoke widths: parts rounded up to 16-byte boundaries
    ((2, 24, 8, 1, 32, 16, 8, True), {},
     2 * 3 * 8 * 32 * 16 + _r4(2 * 3 * 8) + 2 * 3 * 16 * 16 + 2 * 3 * 8 * 64 * 64
     + 2 * 2 * 24 * 8 * 16 + 4 * 2 * 24 * 8 + 2 * 3 * 8 + _r4(2 * 3 * 8)),
])
def test_bwd_workspace(args, plan_over, want):
    plan = {**K6.ssd_bwd_plan(*args), **plan_over}
    assert K6.ssd_bwd_workspace_floats(*args, plan=plan) == want
    if not plan_over:
        assert K6.ssd_bwd_workspace_floats(*args) == want


# ---------------------------------------------------------------------------
# the CUDA wrapper through stand-ins for the card


SMS = 132


def _stand_in_for_the_card(monkeypatch, calls):
    def fake_invoke(entry, dev, *args):
        calls.append((entry, args))
        return 0
    monkeypatch.setattr(K6, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K6, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(K6, "invoke", fake_invoke)
    monkeypatch.setattr(K6.KERNEL, "launches", K6.KERNEL.launches)
    monkeypatch.setattr(K6.KERNEL_BWD, "launches", K6.KERNEL_BWD.launches)


@pytest.mark.parametrize("T,chunk,h0,dhf", [(48, 16, False, False), (48, 16, True, True),
                                            (16, 16, False, False), (16, 16, True, False)])
def test_wrapper_hands_the_backward_its_arguments(monkeypatch, T, chunk, h0, dhf):
    """The forward keeps its chunk states only with several chunks; the
    backward's C entry gets them (or h0 with one chunk) as h_in, null for
    what is zero (dh_final, h0), a null dh0 without h0, the states of dh
    only where they run, and the shapes and strides; one call counts once."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    B, H, P, G, N = 2, 8, 32, 2, 16
    xh, Bm, Cm, dt, A, hinit, dy, dh = (_t(a) for a in make_inputs(
        B, T, H, P, G, N, seed=14, h0=h0, dh_final=dhf))
    y, hf, states = K6.ssd_chunked_cuda(xh, Bm, Cm, dt, A, hinit, chunk)
    Q = ref.ssd_chunk_len(T, chunk)
    nc = T // Q
    assert (states is None) == (nc == 1)
    assert states is None or (states.shape == (B, nc, H, P, N) and states.is_contiguous())
    before = K6.KERNEL_BWD.launches
    dxh, dB, dC, ddt, dA, dh0 = K6.ssd_chunked_bwd_cuda(xh, Bm, Cm, dt, A, hinit, chunk, dy,
                                                        dh, states)
    assert K6.KERNEL_BWD.launches == before + 1
    assert dxh.shape == xh.shape and dB.shape == dC.shape == Bm.shape
    assert ddt.shape == (B, T, H) and dA.shape == (H,) and (dh0 is None) == (not h0)
    entry, a = calls[-1]
    assert entry is K6._bwd_fn
    # (dtype, x, b, c, dt, A, hin, dh_final, dy, dx, dB, dC, ddt, dA, dh0, dhs, dec,
    #  sws, lds, dbp, dcp, rrow, ddir, wst, urow, dAt, dAp, B, T, H, G, P, N, Q, has_h0,
    #  heads_per_block, 12 strides)
    assert len(a) == 1 + 26 + 9 + 12
    assert a[6] == (states.data_ptr() if nc > 1 else (hinit.data_ptr() if h0 else None))
    assert (a[7] is None) == (not dhf) and (a[14] is None) == (not h0)
    runs_states = nc > 1 or h0
    assert all((a[i] is None) == (not runs_states) for i in (15, 16))
    assert all(a[i] is not None for i in range(17, 27))
    assert all(a[i] % 16 == 0 for i in range(15, 27) if a[i] is not None)
    plan = K6.ssd_bwd_plan(B, T, H, G, P, N, Q, h0)
    assert tuple(a[27:35]) == (B, T, H, G, P, N, Q, int(h0))
    assert a[35] == plan["heads_per_block"] == 1
    assert tuple(a[36:39]) == xh.stride()[:3] and tuple(a[45:48]) == dt.stride()


def _bwd_args(**over):
    B, T, H, P, G, N = 1, 16, 4, 16, 1, 16
    a = dict(xh=torch.zeros((B, T, H, P)), B_=torch.zeros((B, T, G, N)),
             C_=torch.zeros((B, T, G, N)), dt=torch.zeros((B, T, H)), A=torch.ones(H),
             h0=None, chunk=8, dy=torch.zeros((B, T, H, P)), dh_final=None,
             states=torch.zeros((B, 2, H, P, N)))
    a.update(over)
    return a


@pytest.mark.parametrize("over,match", [
    ({"dy": torch.zeros((1, 16, 4, 16), dtype=torch.bfloat16)}, "dy must be"),
    ({"dy": torch.zeros((1, 16, 16, 4)).transpose(2, 3)}, "dy must be"),
    ({"dh_final": torch.zeros((1, 4, 16, 8))}, "dh_final must be"),
    ({"states": None}, "states must be"),
    ({"states": torch.zeros((1, 3, 4, 16, 16))}, "states must be"),
    ({"A": None}, "A must be"),
    ({"xh": torch.zeros((1, 16, 4, 12)), "dy": torch.zeros((1, 16, 4, 12))}, "P 12"),
    ({"chunk": 512, "xh": torch.zeros((1, 512, 4, 16)), "B_": torch.zeros((1, 512, 1, 16)),
      "C_": torch.zeros((1, 512, 1, 16)), "dt": torch.zeros((1, 512, 4)),
      "dy": torch.zeros((1, 512, 4, 16))}, "Q 512"),
    ({"xh": torch.zeros(1 * 16 * 4 * 16 + 1)[1:].view(1, 16, 4, 16)}, "16 bytes"),
])
def test_bwd_wrapper_refuses_what_it_cannot_launch(monkeypatch, over, match):
    """The backward's wrapper checks before any launch, the forward's checks
    and its own (dy, dh_final, the forward's states), and nothing falls back
    to the plain backward."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    before = ops.PLAIN_SSD.launches
    with pytest.raises(ValueError, match=match):
        K6.ssd_chunked_bwd_cuda(**_bwd_args(**over))
    assert not calls and ops.PLAIN_SSD.launches == before


def test_bwd_wrapper_refuses_cpu_tensors():
    """Without the stand-ins a CPU tensor is no CUDA device: the wrapper
    raises, and the plain backward does not run."""
    before = ops.PLAIN_SSD.launches
    with pytest.raises(ValueError, match="CUDA device"):
        K6.ssd_chunked_bwd_cuda(**_bwd_args())
    assert ops.PLAIN_SSD.launches == before and K6.KERNEL_BWD.launches == 0


# ---------------------------------------------------------------------------
# chip_smoke's bound for the backward


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("T,dtype,h0,dhf,want_ops,by", [
    (512, "float32", False, False, 17_297_571_840, "operations (3xTF32)"),
    (256, "float32", False, False, 6_501_302_272, "operations (3xTF32)"),
    (512, "bfloat16", True, True, None, "bytes"),
])
def test_bwd_bound_counts_the_causal_half_and_the_nonzero_state_terms(T, dtype, h0, dhf,
                                                                       want_ops, by):
    """``chip_smoke.ssd_bwd_bound`` at mamba2-1.3b's widths, B 4 (shapes only,
    on the meta device), against the list of products the backward needs,
    two operations a multiply-add: c b^T once a group and four products a
    head over the causal half, the dh_out terms only where dh_out is not
    zero (not in the last chunk without a dh_final) and the h_in terms only
    where h_in is not (not in the first chunk without an h0)."""
    cs = _chip_smoke()
    B, H, P, N, G, Q = 4, 64, 64, 128, 1, 256

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")
    c = dict(xh=meta(B, T, H, P, dt=getattr(torch, dtype)),
             B=meta(B, T, G, N, dt=getattr(torch, dtype)), dt=meta(B, T, H),
             h0=meta(B, H, P, N) if h0 else None, chunk=Q, dtype=dtype)
    b = cs.ssd_bwd_bound(torch, ref, c, meta(B, H, P, N) if dhf else None)
    nc, causal = T // Q, Q * (Q + 1) // 2     # (i, j) pairs with i >= j
    products = []                             # (name, copies, pairs, inner) a batch element
    for k in range(nc):
        products.append(("S = c b^T", G, causal, N))
        products += [("D = dy x^T", H, causal, P), ("dx: (S o L)^T dy", H, causal, P),
                     ("db: (L o D)^T c", H, causal, N), ("dc: (L o D dt) b", H, causal, N)]
        if k < nc - 1 or dhf:                 # dh_out is not zero
            products += [("dx: dh_out b", H, Q, P * N), ("db: dh_out^T x", H, Q, P * N)]
        if k > 0 or h0:                       # h_in is not zero, and dh_in is wanted
            products += [("dc: h_in^T dy", H, Q, P * N), ("dh_in: dy c^T", H, Q, P * N)]
    ops_ = B * sum(2 * copies * pairs * inner for _, copies, pairs, inner in products)
    assert b["ops"] == ops_ and (want_ops is None or ops_ == want_ops)
    assert b["bound_by"] == by
    peak = 495e12 / 3 if dtype == "float32" else 989e12
    assert math.isclose(b["bound_ms"], 1e3 * max(ops_ / peak, b["bytes"] / 3.35e12))
    assert math.isclose(b["bound_simt_ms"], 1e3 * max(ops_ / 67e12, b["bytes"] / 3.35e12))


def test_phase_2d_fp32_gate_reads_each_head():
    """``chip_smoke.per_head_rel``, the fp32 gate's per-head measure: a fault
    confined to a weak head (1% off in a head whose values are 1e-3 of the
    others') stays under 1e-4 of the tensor's largest entry, the per-tensor
    rule, but not under 1e-4 of its head's; the other heads read 0, a head
    of one value (dA) reads its error over the scale given, and a head whose
    scale is 0 reads the plain difference."""
    cs = _chip_smoke()
    rng = np.random.default_rng(21)
    exact = torch.from_numpy(rng.standard_normal((2, 16, 4)))
    exact[:, :, 3] *= 1e-3
    bad = exact.clone()
    bad[:, :, 3] *= 1.01
    assert float((bad - exact).abs().max() / exact.abs().max()) < 1e-4
    rel = cs.per_head_rel(torch, bad, exact, 2)
    assert rel.shape == (4,) and torch.all(rel[:3] == 0)
    assert math.isclose(float(rel[3]), 0.01, rel_tol=1e-9)
    dA = cs.per_head_rel(torch, torch.tensor([3.0, 2e-3, 0.5]), torch.tensor([3.0, 1e-3, 0.0]),
                         0, torch.tensor([6.0, 1e-2, 0.0]))
    assert torch.allclose(dA, torch.tensor([0.0, 0.1, 0.5]))
    assert set(cs.SSD_GRAD_HEAD_AXIS) == set(NAMES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dA_terms_sum_to_dA(case):
    """``chip_smoke.ssd_dA_terms``, the scale of phase 2d's per-head dA
    gate: from the exact gradients, -sum over (batch, position) of dt dl =
    (x . dx - dt ddt) / A is dA, to fp64 rounding (1e-9 of the sum of the
    terms' magnitudes, the scale itself)."""
    cs = _chip_smoke()
    _, B, T, H, P, G, N, chunk, kw = case
    xh, Bm, Cm, dt, A, hinit, dy, dhf = (None if a is None else torch.from_numpy(a).double()
                                         for a in make_inputs(B, T, H, P, G, N, seed=31, **kw))
    dxh, _, _, ddt, dA, _ = ref.ssd_chunked_bwd_ref(xh, Bm, Cm, dt, A, hinit, chunk, dy, dhf)
    terms = cs.ssd_dA_terms(xh, dt, A, dxh, ddt)
    assert terms.shape == (B, T, H)
    scale = terms.abs().sum((0, 1))
    assert torch.all((-terms.sum((0, 1)) - dA).abs() <= 1e-9 * scale)
