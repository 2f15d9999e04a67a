"""The arithmetic of K6 (``csrc/ssd_chunk.cu``), emulated on the CPU and held
against the port's plain scan ``ref.ssd_chunked_ref``, the Pallas kernel
``ssd_chunk_pallas`` in interpret mode and the JAX model's
``Mamba2LM._ssd_chunked``, on the same numpy-seeded inputs.

K6 runs four products on the tensor cores: S = C B^T (once per group, then
each head's decay and dt), y = (S * decay * dt) X over the key tiles at or
below the diagonal, the carried-in state's term (C h_in^T) * exp(cs), and
the state (X * w)^T B.  fp32 inputs run each as three tf32 products (big =
x with its low 13 bits cleared, small = x - big, both read as tf32 by the
tensor cores).  bf16 inputs are exact bf16 operands, and an fp32
intermediate (the decayed scores, X * w, the carried-in state) enters as a
bf16 pair hi + lo.  The emulation rounds operands as the kernel does, pads
each chunk to 16-row tiles with zero rows, takes the prefix sum of the
log-decay in runs of 8 rows a lane plus a scan of the run totals (in log2
units, as the kernel's ex2), adds the key tiles in the kernel's order, and
with several chunks computes every chunk's state from zero and c b^T once
per group,
carries the states over the chunks in order and then the outputs from the
carried-in states.  It does not model the tensor cores' accumulation order;
``chip_smoke.py`` holds the kernel itself on the card.

Also here: the grid rule ``ssd_plan`` as a plain function of shapes, the
workspace and device-kernel counts, and the wrapper's geometry and 16-byte
checks through stand-ins for the card.

Tolerances: fp32 2e-4 absolute plus relative, the JAX package's own for K6
(``tests/test_kernels.py``); bf16 a quarter of phase 2d's 1e-2 gate against
the fp32 scan of the same bf16 inputs.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as K6
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 2e-4               # fp32, absolute plus relative
BF16_TOL = 1e-2 / 4      # a quarter of phase 2d's bf16 gate
TILE = K6.ROW_TILE       # rows of a row tile, keys of a key tile
STATE_STAGE = 32         # keys per stage of a state block's ring
MAXQ = K6.MAX_Q
LOG2E = 1.4426950408889634
SMS = 132                # an H100's SMs, for the grid rule


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as the tensor cores read a 32-bit operand: the low 13
    bits dropped (the kernel's split clears them itself for big)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def product(eq: str, a: torch.Tensor, b: torch.Tensor, route: str, split: str = "") -> torch.Tensor:
    """``einsum(eq, a, b)`` with the kernel's operand rounding.  ``split``
    names the operand ("a" or "b") that is an fp32 intermediate in the bf16
    route: it enters as hi + lo (``route == "bf16"``) or rounded once
    (``"bf16_rounded"``); the other is a bf16 value already.  Products of
    tf32 or bf16 values are exact in fp32."""
    if route == "3xtf32":
        ab, bb = tf32_trunc(a), tf32_trunc(b)
        as_, bs = tf32_trunc(a - ab), tf32_trunc(b - bb)
        return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
                + torch.einsum(eq, ab, bb))
    if route == "tf32":
        return torch.einsum(eq, tf32_trunc(a), tf32_trunc(b))
    if not split:
        return torch.einsum(eq, a, b)
    x = a if split == "a" else b
    hi = bf16(x)
    parts = [hi] if route == "bf16_rounded" else [hi, bf16(x - hi)]
    return sum(torch.einsum(eq, p, b) if split == "a" else torch.einsum(eq, a, p)
               for p in parts)


def cumsum_runs(l: torch.Tensor) -> torch.Tensor:
    """The kernel's inclusive prefix sum of l [..., Q] (Q <= 256): runs of 8
    rows a lane summed in order, a Hillis-Steele scan of the 32 run totals,
    each run's base added to its running sums; times log2(e)."""
    Q = l.shape[-1]
    lz = torch.zeros(l.shape[:-1] + (MAXQ,), dtype=torch.float32)
    lz[..., :Q] = l
    runs = lz.reshape(l.shape[:-1] + (32, 8))
    v = torch.zeros_like(runs)
    acc = torch.zeros(runs.shape[:-1])
    for i in range(8):
        acc = acc + runs[..., i]
        v[..., i] = acc
    incl = acc.clone()
    o = 1
    while o < 32:
        shifted = torch.zeros_like(incl)
        shifted[..., o:] = incl[..., :-o]
        incl = incl + shifted
        o *= 2
    base = incl - acc
    return ((base[..., None] + v) * LOG2E).reshape(l.shape[:-1] + (MAXQ,))[..., :Q]


def pad_rows(t: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """``t`` with zero rows appended along ``dim`` up to ``rows``."""
    shape = list(t.shape)
    shape[dim] = rows - t.shape[dim]
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype)], dim=dim)


def emulated_chunk(x, b, c, dt, l, hin, route):
    """One chunk of one batch row, as an output block and a state block
    compute it.  x [H,Q,P]; b/c [G,Q,N]; dt/l [H,Q]; hin [H,P,N] or None.
    Returns (y [H,Q,P], the state from zero [H,P,N], cs_Q * log2(e) [H])."""
    H, Q, P = x.shape
    G = b.shape[0]
    rep = H // G
    nq = -(-Q // TILE)
    R = nq * TILE                       # rows of the chunk's tiles, zero past Q
    x, b, c = pad_rows(x, R, 1), pad_rows(b, R, 1), pad_rows(c, R, 1)
    dtp = pad_rows(dt, R, 1)
    cs2 = pad_rows(cumsum_runs(l), R, 1)
    cs2[:, Q:] = cs2[:, Q - 1:Q]        # past Q the log-decay is 0
    # S = C B^T once per group, then each head's decay and dt
    s = product("gin,gjn->gij", c, b, route).repeat_interleave(rep, 0)
    i = torch.arange(R)[:, None]
    j = torch.arange(R)[None, :]
    below = (j <= i)[None]
    arg = torch.where(below, cs2[:, :, None] - cs2[:, None, :], float("-inf"))
    m = torch.where(below, s * torch.exp2(arg) * dtp[:, None, :], 0.0)
    # the carried-in state's term first, then the key tiles in order
    y = torch.zeros((H, R, P))
    if hin is not None:
        ch = c.repeat_interleave(rep, 0)
        y = product("hin,hpn->hip", ch, hin, route, split="b") * torch.exp2(cs2)[:, :, None]
    for kt in range(nq):
        sl = slice(kt * TILE, (kt + 1) * TILE)
        y = y + product("hij,hjp->hip", m[:, :, sl], x[:, sl], route, split="a")
    # the state: (X * w)^T B over stages of 32 keys, in order
    csl = cs2[:, Q - 1]
    w = dtp * torch.exp2(csl[:, None] - cs2)
    bh = b.repeat_interleave(rep, 0)
    state = torch.zeros((H, P, b.shape[2]))
    for k0 in range(0, R, STATE_STAGE):
        sl = slice(k0, k0 + STATE_STAGE)
        state = state + product("hjp,hjn->hpn", x[:, sl] * w[:, sl, None], bh[:, sl], route,
                                split="a")
    return y[:, :Q], state, csl


def emulated_scan(xh, B_, C_, dt, A, h0, chunk, route, l=None):
    """The whole scan as K6 computes it: xh [B,T,H,P], B_/C_ [B,T,G,N] (bf16
    values for the bf16 routes), dt [B,T,H], A [H] or the log-decay l
    [B,T,H], h0 [B,H,P,N] or None.  One chunk: outputs from h0 and h_final
    = exp(cs_Q) h0 + state.  Several: every chunk's state from zero, the
    ordered carry, then the outputs from the carried-in states."""
    Bsz, T, H, P = xh.shape
    Q = ref.ssd_chunk_len(T, chunk)
    nc = T // Q
    if l is None:
        l = -dt * A
    ys, hs = [], []
    for bi in range(Bsz):
        def part(t, k):
            return t[bi, k * Q:(k + 1) * Q].transpose(0, 1)
        h = None if h0 is None else h0[bi]
        if nc == 1:
            y, s, csl = emulated_chunk(part(xh, 0), part(B_, 0), part(C_, 0), part(dt, 0),
                                       part(l, 0), h, route)
            hf = s if h is None else torch.exp2(csl)[:, None, None] * h + s
            ys.append(y.transpose(0, 1))
            hs.append(hf)
            continue
        states = [emulated_chunk(part(xh, k), part(B_, k), part(C_, k), part(dt, k),
                                 part(l, k), None, route)[1:] for k in range(nc)]
        hin = []
        hc = torch.zeros((H, P, B_.shape[3])) if h is None else h
        for s, csl in states:                       # the ordered carry
            hin.append(hc)
            hc = torch.exp2(csl)[:, None, None] * hc + s
        yk = [emulated_chunk(part(xh, k), part(B_, k), part(C_, k), part(dt, k), part(l, k),
                             None if (k == 0 and h is None) else hin[k], route)[0]
              for k in range(nc)]
        ys.append(torch.cat(yk, 1).transpose(0, 1))
        hs.append(hc)
    return torch.stack(ys), torch.stack(hs)


def _softplus(x):
    return np.log1p(np.exp(x))


def make_inputs(B, T, H, P, G, N, seed=0, lens=None, strong=False, h0=True):
    """Inputs as a Mamba-2 prefill gives them to the scan (chip_smoke's
    ``make_ssd_case``, from numpy): x, b, c of conv-and-SiLU magnitude, dt =
    softplus over the init's dt range, A = 1 .. 16 over the heads, dt = 0
    at or past a row's length; ``strong``: A 16 and dt 0.1 everywhere."""
    rng = np.random.default_rng(seed)

    def silu(z):
        return z / (1.0 + np.exp(-z))
    xh = silu(rng.standard_normal((B, T, H, P))).astype(np.float32)
    Bm = silu(rng.standard_normal((B, T, G, N))).astype(np.float32)
    Cm = silu(rng.standard_normal((B, T, G, N))).astype(np.float32)
    bias = np.log(np.expm1(np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H))))
    dt = _softplus(0.5 * rng.standard_normal((B, T, H)) + bias).astype(np.float32)
    A = np.linspace(1.0, 16.0, H).astype(np.float32)
    if strong:
        dt[:] = 0.1
        A[:] = 16.0
    if lens is not None:
        dt = np.where(np.arange(T)[None, :, None] < np.array(lens)[:, None, None], dt, 0.0)
    hinit = (0.5 * rng.standard_normal((B, H, P, N)) if h0 else np.zeros((B, H, P, N)))
    return [a.astype(np.float32) for a in (xh, Bm, Cm, dt, A, hinit)]


def excess(got, want, tol):
    """max(|got - want| - tol (1 + |want|)); <= 0 where within the tolerance."""
    return float(((got - want).abs() - tol * (1 + want.abs())).max())


def torch_args(arrs, bf16_inputs=False):
    t = [torch.from_numpy(a) for a in arrs]
    if bf16_inputs:
        t[:3] = [bf16(a) for a in t[:3]]
    return t


# name -> (B, T, H, P, G, N, chunk, lens, strong, h0)
CASES = {
    "q1_t13": (2, 13, 4, 16, 1, 16, 1, [13, 6], False, True),         # 13 chunks of 1 row
    "q8_t24": (2, 24, 4, 16, 2, 16, 8, [24, 17], False, True),        # G 2, 3 chunks
    "q150_t300": (1, 300, 4, 32, 1, 32, 256, None, False, True),      # 2 chunks of 150
    "q213_t213": (2, 213, 4, 16, 1, 32, 256, [213, 101], False, False),  # one ragged chunk
    "q256_t512": (1, 512, 4, 16, 4, 16, 256, None, False, True),      # G = H, 2 chunks
    "q16_t16_b8": (8, 16, 8, 64, 1, 128, 256, [15, 12, 9, 15, 7, 10, 13, 11], False, False),
}


def run_case(name, route, seed=0):
    B, T, H, P, G, N, chunk, lens, strong, h0 = CASES[name]
    arrs = make_inputs(B, T, H, P, G, N, seed=seed + T, lens=lens, strong=strong, h0=h0)
    xh, Bm, Cm, dt, A, hinit = torch_args(arrs, bf16_inputs=route.startswith("bf16"))
    want = ref.ssd_chunked_ref(xh, Bm, Cm, dt, A, hinit, chunk)
    got = emulated_scan(xh, Bm, Cm, dt, A, hinit if h0 else None, chunk, route)
    return got, want, arrs


@pytest.mark.parametrize("name", list(CASES))
def test_three_tf32_products_meet_the_fp32_tolerance(name):
    """fp32: the emulated kernel against the port's plain scan, padding
    rows at Q 1, 8, 150, 213 and 256 included."""
    (y, h), (wy, wh), _ = run_case(name, "3xtf32")
    assert excess(y, wy, TOL) <= 0 and excess(h, wh, TOL) <= 0


@pytest.mark.parametrize("name", ["q8_t24", "q150_t300", "q213_t213"])
def test_emulation_matches_the_jax_model(name):
    """fp32: the emulated kernel against ``Mamba2LM._ssd_chunked`` of the
    JAX package on the same inputs (its chunk set to the case's)."""
    B, T, H, P, G, N, chunk, lens, strong, h0 = CASES[name]
    jcfg = JR.get_smoke_config("mamba2-1.3b")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=chunk))
    jm = JR.build_model(jcfg)
    (y, h), _, arrs = run_case(name, "3xtf32")
    xh, Bm, Cm, dt, A, hinit = arrs
    wy, wh = jm._ssd_chunked({"A_log": jnp.log(jnp.asarray(A))},
                             *(jnp.asarray(a) for a in (xh, Bm, Cm, dt, hinit)))
    assert excess(y, torch.from_numpy(np.array(wy)), TOL) <= 0
    assert excess(h, torch.from_numpy(np.array(wh)), TOL) <= 0


@pytest.mark.parametrize("Q,P,N", [(8, 8, 16), (16, 64, 128), (37, 16, 32)])
def test_one_chunk_contract_matches_the_pallas_kernel(Q, P, N):
    """The one-chunk contract [BH, Q, ...] with an explicit log-decay, as
    ``ssd_chunk_cuda`` hands it to K6 (one slice a group), against
    ``ssd_chunk_pallas`` in interpret mode."""
    rng = np.random.default_rng(Q + P)
    BH = 3
    x = rng.standard_normal((BH, Q, P)).astype(np.float32)
    b = (0.3 * rng.standard_normal((BH, Q, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((BH, Q, N))).astype(np.float32)
    dt = _softplus(rng.standard_normal((BH, Q))).astype(np.float32)
    l = -_softplus(rng.standard_normal((BH, Q))).astype(np.float32)
    h0 = rng.standard_normal((BH, P, N)).astype(np.float32)
    wy, wh = ssd_chunk_pallas(*(jnp.asarray(a) for a in (x, b, c, dt, l, h0)), interpret=True)
    t = torch.from_numpy
    y, h = emulated_scan(t(x)[:, :, None], t(b)[:, :, None], t(c)[:, :, None],
                         t(dt)[:, :, None], None, t(h0)[:, None], Q, "3xtf32",
                         l=t(l)[:, :, None])
    assert excess(y[:, :, 0], t(np.asarray(wy)), TOL) <= 0
    assert excess(h[:, 0], t(np.asarray(wh)), TOL) <= 0


@pytest.mark.parametrize("name", ["q150_t300", "q16_t16_b8"])
def test_one_tf32_product_misses_the_fp32_tolerance(name):
    """Why three products: one tf32 product (10 bits of each operand)
    misses 2e-4 by far."""
    (y, h), (wy, wh), _ = run_case(name, "tf32")
    assert max(excess(y, wy, TOL), excess(h, wh, TOL)) > 0


def test_chunk_parallel_states_and_ordered_carry_equal_the_chunk_loop():
    """Every chunk's state from zero, carried over the chunks in order, then
    the outputs from the carried-in states: the same scan as chaining the
    one-chunk computation (the model's loop), up to rounding."""
    B, T, H, P, G, N = 2, 64, 4, 16, 1, 16
    arrs = make_inputs(B, T, H, P, G, N, seed=3, lens=[64, 40])
    xh, Bm, Cm, dt, A, hinit = torch_args(arrs)
    y, h = emulated_scan(xh, Bm, Cm, dt, A, hinit, 16, "3xtf32")      # 4 chunks, parallel
    ys, hc = [], hinit
    for k in range(4):                                               # 4 chained one-chunk scans
        sl = slice(16 * k, 16 * (k + 1))
        yk, hc = emulated_scan(xh[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl], A, hc, 16, "3xtf32")
        ys.append(yk)
    assert excess(y, torch.cat(ys, 1), TOL) <= 0 and excess(h, hc, TOL) <= 0


def test_zero_state_is_a_null_h0():
    """h0 None (the model's prefill) gives what zeros give."""
    B, T, H, P, G, N = 2, 40, 4, 16, 1, 16
    arrs = make_inputs(B, T, H, P, G, N, seed=4, h0=False)
    xh, Bm, Cm, dt, A, zeros = torch_args(arrs)
    for chunk in (40, 8):
        y0, h0 = emulated_scan(xh, Bm, Cm, dt, A, None, chunk, "3xtf32")
        yz, hz = emulated_scan(xh, Bm, Cm, dt, A, zeros, chunk, "3xtf32")
        assert torch.equal(y0, yz) and torch.equal(h0, hz)
        py, ph = ops.ssd_chunked(xh, Bm, Cm, dt, A, None, chunk)
        wy, wh = ref.ssd_chunked_ref(xh, Bm, Cm, dt, A, zeros, chunk)
        assert torch.equal(py, wy) and torch.equal(ph, wh)


def test_group_scores_are_shared_by_its_heads():
    """S = C B^T once per group serves every head of it: the emulation at G
    = 2 (4 heads a group) against the plain scan, which repeats B and C per
    head."""
    B, T, H, P, G, N = 1, 48, 8, 16, 2, 32
    arrs = make_inputs(B, T, H, P, G, N, seed=5)
    xh, Bm, Cm, dt, A, hinit = torch_args(arrs)
    (y, h), (wy, wh) = (emulated_scan(xh, Bm, Cm, dt, A, hinit, 48, "3xtf32"),
                        ref.ssd_chunked_ref(xh, Bm, Cm, dt, A, hinit, 48))
    assert excess(y, wy, TOL) <= 0 and excess(h, wh, TOL) <= 0


# ---------------------------------------------------------------------------
# bf16: exact bf16 inputs, fp32 intermediates as hi + lo or rounded once

# phase 2d's two worst cases for a rounded operand, at 8 of the 64 heads
BF16_CASES = {
    "prefill_b4_t2048": (4, 2048, 8, 64, 1, 128, 256, [2048, 1500, 777, 64], False, False),
    "strong_decay_t512": (2, 512, 8, 64, 1, 128, 256, None, True, True),
}


def bf16_errors(name):
    B, T, H, P, G, N, chunk, lens, strong, h0 = BF16_CASES[name]
    arrs = make_inputs(B, T, H, P, G, N, seed=11, lens=lens, strong=strong, h0=h0)
    xh, Bm, Cm, dt, A, hinit = torch_args(arrs, bf16_inputs=True)
    wy, wh = ref.ssd_chunked_ref(xh, Bm, Cm, dt, A, hinit, chunk)
    out = {}
    for route in ("bf16", "bf16_rounded"):
        y, h = emulated_scan(xh, Bm, Cm, dt, A, hinit if h0 else None, chunk, route)
        out[route] = max(float(((y - wy).abs() / (1 + wy.abs())).max()),
                         float(((h - wh).abs() / (1 + wh.abs())).max()))
    return out


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_split_intermediates_stay_under_a_quarter_of_the_gate(name):
    """The kernel's bf16 rule: x, b, c exact, every fp32 intermediate as hi +
    lo.  Over a 2048-row carry and under strong decay its error against the
    fp32 scan of the same inputs stays under a quarter of the 1e-2 gate; the
    error of intermediates rounded once to bf16 is printed beside it."""
    errs = bf16_errors(name)
    print(f"{name}: bf16 error (|d| / (1 + |want|)), hi + lo {errs['bf16']:.3e}, "
          f"rounded once {errs['bf16_rounded']:.3e}")
    assert errs["bf16"] <= BF16_TOL
    assert errs["bf16"] < errs["bf16_rounded"]


# ---------------------------------------------------------------------------
# the grid rule, the workspace and the device kernels, as plain functions

SHAPES = [   # (B, T, H, G, P, N, chunk): phase 2d's cases and the smoke widths
    (8, 16, 64, 1, 64, 128, 256), (1, 64, 64, 1, 64, 128, 256), (1, 128, 64, 1, 64, 128, 256),
    (1, 256, 64, 1, 64, 128, 256), (4, 2048, 64, 1, 64, 128, 256),
    (1, 256, 64, 8, 64, 128, 256), (2, 300, 64, 1, 64, 128, 256), (2, 257, 64, 1, 64, 128, 256),
    (256, 256, 1, 1, 64, 128, 256), (2, 24, 8, 1, 32, 16, 8), (1, 256, 4, 1, 128, 128, 256),
    (2, 64, 6, 3, 16, 32, 64), (1, 64, 6, 2, 128, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_ssd_plan_is_a_legal_grid_of_shapes_only(shape):
    """The plan's heads per block divide a group's heads, the blocks cover
    every (batch, chunk, row tile, head) once, the state split fits the
    kernel's tiles, and the same shapes give the same plan."""
    B, T, H, G, P, N, chunk = shape
    Q = ref.ssd_chunk_len(T, chunk)
    plan = K6.ssd_plan(B, T, H, G, P, N, Q, SMS)
    assert plan == K6.ssd_plan(B, T, H, G, P, N, Q, SMS)
    wr, nspl, hb = plan["wr"], plan["nspl"], plan["heads_per_block"]
    assert wr in (1, 2, 4) and hb * wr == K6.WARPS and (H // G) % hb == 0
    nq, nc = -(-Q // TILE), T // Q
    assert plan["out_blocks"] == B * nc * -(-nq // wr) * (H // hb)
    n8 = -(-N // 16) * 2
    assert 1 <= nspl <= n8 and -(-n8 // nspl) <= (16 if P <= 64 else 8)
    assert plan["state_blocks"] == B * nc * H * nspl
    assert plan["device_kernels"] == K6.ssd_device_kernels(nc)


@pytest.mark.parametrize("T", [64, 128, 256])
def test_ssd_plan_fills_the_card_at_the_serving_prefills(T):
    """B 1, T 64-256 at mamba2-1.3b's widths: at least one block an SM."""
    plan = K6.ssd_plan(1, T, 64, 1, 64, 128, T, SMS)
    assert plan["out_blocks"] + plan["state_blocks"] >= SMS


def test_workspace_and_device_kernels():
    assert K6.ssd_device_kernels(1) == 1 and K6.ssd_device_kernels(8) == 3
    assert K6.ssd_workspace_floats(1, 256, 64, 1, 64, 128, 256) == 0
    assert K6.ssd_workspace_floats(4, 2048, 64, 1, 64, 128, 256) == \
        4 * 8 * (64 * (64 * 128 + 1) + 256 * 256) + 3
    assert K6.ssd_workspace_floats(2, 257, 64, 1, 64, 128, 1) == \
        2 * 257 * (64 * (64 * 128 + 1) + 16 * 16) + 3


def _stand_in_for_the_card(monkeypatch, calls):
    def fake_invoke(entry, dev, *args):
        calls.append(args)
        return 0
    monkeypatch.setattr(K6, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K6, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(K6, "invoke", fake_invoke)
    monkeypatch.setattr(K6.KERNEL, "launches", K6.KERNEL.launches)


@pytest.mark.parametrize("T,chunk,zero", [(64, 256, True), (64, 16, False), (48, 16, True)])
def test_wrapper_hands_the_kernel_its_plan(monkeypatch, T, chunk, zero):
    """The C entry gets the plan of the shapes, a workspace only with several
    chunks (its chunk states the tensor returned), and a null h0 for a zero
    state; a call counts once whatever device kernels it issues."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    B, H, P, G, N = 2, 8, 32, 1, 16
    xh, Bm, Cm, dt, A, hinit = torch_args(make_inputs(B, T, H, P, G, N, seed=6))
    before = K6.KERNEL.launches
    y, h, states = K6.ssd_chunked_cuda(xh, Bm, Cm, dt, A, None if zero else hinit, chunk)
    assert y.shape == (B, T, H, P) and h.shape == (B, H, P, N)
    assert K6.KERNEL.launches == before + 1
    (a,) = calls
    Q = ref.ssd_chunk_len(T, chunk)
    plan = K6.ssd_plan(B, T, H, G, P, N, Q, SMS)
    # (dtype, x, b, c, dt, l, A, h0, y, h_out, ws, dec, sws, B, T, H, G, P, N, Q,
    #  12 strides, wr, nspl)
    assert (a[7] is None) == zero and a[5] is None
    assert all((a[i] is None) == (T == Q) for i in (10, 11, 12))
    assert T == Q or a[12] % 16 == 0
    # the chunk states are the returned tensor, apart from the rest of the workspace
    assert (states is None) == (T == Q) and a[10] == (None if T == Q else states.data_ptr())
    assert tuple(a[13:20]) == (B, T, H, G, P, N, Q)
    assert tuple(a[32:34]) == (plan["wr"], plan["nspl"])


@pytest.mark.parametrize("which", ["xh", "B_", "C_"])
def test_wrapper_rejects_unaligned_copies(monkeypatch, which):
    """16-byte copies need 16-byte bases and strides: the wrapper raises
    before any launch, with no other route."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    xh, Bm, Cm, dt, A, hinit = torch_args(make_inputs(1, 16, 4, 16, 1, 16, seed=7))
    args = dict(xh=xh, B_=Bm, C_=Cm)
    t = args[which]
    flat = torch.zeros(t.numel() + 1)
    off = flat[1:].view(t.shape)                      # 4 bytes past a 16-byte boundary
    off.copy_(t)
    args[which] = off
    with pytest.raises(ValueError, match="16 bytes"):
        K6.ssd_chunked_cuda(args["xh"], args["B_"], args["C_"], dt, A, hinit, 16)
    assert not calls


def test_wrapper_rejects_widths_without_a_tile():
    """P and N must be multiples of 8 (the 16-byte copies and the mma
    tiles), up to 128."""
    xh = torch.zeros((1, 8, 4, 12))
    with pytest.raises(ValueError, match="P 12"):
        K6.ssd_chunked_cuda(xh, torch.zeros((1, 8, 1, 16)), torch.zeros((1, 8, 1, 16)),
                            torch.zeros((1, 8, 4)), torch.ones(4), None, 8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,T,dtype,h0,want_ms,by", [
    (1, 256, "bfloat16", False, 0.0025628, "bytes"),
    (1, 256, "bfloat16", True, 0.0031888, "bytes"),
    (4, 2048, "float32", False, 0.15151, "operations (3xTF32)"),
    (4, 2048, "bfloat16", False, 0.064480, "bytes"),
])
def test_bound_counts_its_route_and_c_b_once_a_group(B, T, dtype, h0, want_ms, by):
    """``chip_smoke.ssd_bound`` at mamba2-1.3b's widths (shapes only, on the
    meta device): c b^T once per (batch, group, chunk), h0's bytes and
    carried-in term only where there is a state, fp32 as three tf32
    products at the tf32 peak."""
    cs = _chip_smoke()
    H, P, N, G = 64, 64, 128, 1
    dt_ = getattr(torch, dtype)

    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")
    c = dict(xh=meta(B, T, H, P, dt=dt_), B=meta(B, T, G, N, dt=dt_), dt=meta(B, T, H),
             h0=meta(B, H, P, N) if h0 else None, chunk=256, dtype=dtype)
    b = cs.ssd_bound(torch, ref, c)
    assert math.isclose(b["bound_ms"], want_ms, rel_tol=1e-4) and b["bound_by"] == by
    per_head = B * H * (T // 256) * (256 * 257 * (N + P) + 4 * 256 * P * N)
    assert b["ops"] < 0.65 * per_head
