"""The arithmetic of K4's backward kernels (``csrc/flash_attn.cu``),
emulated on the CPU and held against the port's plain backward
``ref.flash_attn_bwd_ref``, autograd through ``ref.gqa_masked_ref`` and
``jax.vjp`` of the JAX model's ``flash_attention_train``.

The backward runs five products on the tensor cores: S = Q K^T and dP =
dO V^T (in both kernels), then dQ = dS K, dV = P^T dO and dK = dS^T Q.  In
fp32 each is three tf32 products (big*big + big*small + small*big) with
big = x with its low 13 bits cleared and small = x - big, which the tensor
cores read as tf32 by dropping its low 13 bits; in bf16, P and dS are
rounded to bf16 where they are A operands.  The emulation rounds operands
as the kernels do, walks the tiles in the kernels' order
(dQ: 32-key tiles; dK/dV: blocks of 64 keys over 32-row tiles of folded
query rows ``g*T + t``), skips the query tiles the kernel skips, gives each
split its share of the ordered list of visible query tiles and sums the
splits' fp32 partials in split order, as ``flash_bwd_combine`` does.  It
does not model the tensor cores' accumulation order; ``chip_smoke.py``
holds the kernels themselves on the card.

Also here: a lane-by-lane model of ``mma.sync`` m16n8k8 showing that the
fp32 kernels' permuted k index (the accumulator fragment reused as the A
operand, the B rows read in the order 2t, 2t+1) computes the product; the
split rule, the workspace and the device-kernel count as plain functions;
the wrapper's geometry and 16-byte alignment check through stand-ins for
the card.

Tolerances: fp32 1e-4 absolute plus relative (``chip_smoke.GRAD_TOL``),
the same bound the plain backward is held to against ``jax.vjp``
(``tests/test_torch_flash_attn.py``); bf16 1e-2 in relative RMS against
the fp32 gradients of the same bf16 inputs (P and dS each rounded once to
8 bits, about 4e-3 relative, and the outputs once more).
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcm
from repro_torch.kernels import flash_attn as K4
from repro_torch.kernels import ref
from test_torch_flash_fwd_numerics import excess
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

GRAD_TOL = 1e-4          # fp32, absolute plus relative
BF16_RMS_TOL = 1e-2      # bf16, relative RMS against fp32 gradients
KEY_TILE = 32            # the dQ kernel's key tile
SMS = 132                # an H100's SMs, for the split rule

# name -> (B, T, KVH, G, hd, window, prefix_len, lens)
CASES = {
    "g1_causal_hd64": (2, 40, 2, 1, 64, None, 0, None),
    "g2_causal_hd128": (2, 40, 2, 2, 128, None, 0, None),
    "g7_causal_t37_hd128": (2, 37, 1, 7, 128, None, 0, None),   # 32-row tiles span heads
    "g8_window_hd64": (2, 40, 1, 8, 64, 9, 0, None),
    "g2_prefix_hd64": (2, 40, 2, 2, 64, None, 5, None),
    "g2_window_prefix_hd128": (2, 45, 1, 2, 128, 7, 3, None),
    "g2_padded_masked_hd64": (3, 40, 2, 2, 64, None, 0, [40, 0, 23]),
    "g8_causal_t70_hd128": (2, 70, 1, 8, 128, None, 0, None),    # two key blocks
}


def make_case(name, bf16=False, seed=0):
    B, T, KVH, G, hd, window, prefix_len, lens = CASES[name]
    rng = np.random.default_rng(seed + hd + 7 * G)
    H = KVH * G
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for shape in ((B, T, H, hd), (B, T, KVH, hd), (B, T, KVH, hd),
                                 (B, T, H, hd)))
    if bf16:
        q, k, v, do = (x.bfloat16().float() for x in (q, k, v, do))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    if lens is not None:
        pos = np.where(pos < np.array(lens)[:, None], pos, -1).astype(np.int32)
    kw = dict(window=window, prefix_len=prefix_len)
    return q, k, v, do, torch.from_numpy(pos), kw


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 as the tensor cores read a 32-bit operand: the low 13
    bits dropped (``bwd_split`` clears them itself for big)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` with the backward's operand rounding; products
    of tf32 or bf16 values are exact in fp32."""
    if route == "3xtf32":
        ab, bb = tf32_trunc(a), tf32_trunc(b)
        as_, bs = tf32_trunc(a - ab), tf32_trunc(b - bb)
        return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
                + torch.einsum(eq, ab, bb))
    if route == "tf32":
        return torch.einsum(eq, tf32_trunc(a), tf32_trunc(b))
    return torch.einsum(eq, a, b)        # bf16: operands are bf16 values already


# ---------------------------------------------------------------------------
# the query-tile scan and the split of the dK/dV kernel


def key_span(kp):
    """(least, greatest position, which keys are valid) of a key block, as
    the kernel's KeySpan; ``kp`` holds BWD_ROWS positions, -1 past L; None
    when no key is valid."""
    valid = kp >= 0
    if not valid.any():
        return None
    return int(kp[valid].min()), int(kp[valid].max()), valid


def query_maybe_visible(qp, kp, window, prefix_len):
    """The kernel's test: could a query at qp see some key of the block?"""
    span = key_span(kp)
    if span is None:
        return False
    lo, hi, valid = span
    if prefix_len and bool((kp[valid] < prefix_len).any()):
        return True
    return qp >= lo and (window is None or qp - window < hi)


def visible_q_tiles(qpf, kp, window, prefix_len, tile=K4.BWD_Q_TILE):
    """The query tiles (of ``tile`` folded rows) some key of the block may
    see, in order."""
    n = -(-len(qpf) // tile)
    return [t for t in range(n)
            if any(query_maybe_visible(int(x), kp, window, prefix_len)
                   for x in qpf[t * tile:(t + 1) * tile])]


def split_share(vis, splits, c):
    """Split c's share of the ordered visible list: ``[c*P, c*P + P)``."""
    per = -(-len(vis) // splits)
    return vis[c * per:(c + 1) * per]


# ---------------------------------------------------------------------------
# the emulation


def emulated_backward(q, k, v, o, do, lse, q_pos, k_pos, window, prefix_len, route,
                      splits):
    """K4's backward as its kernels compute it, up to summation order inside
    a product.  Returns (dq, dk, dv) in fp32 (bf16-rounded for "bf16")."""
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    G, GT = H // KVH, (H // KVH) * T
    scale = 1.0 / math.sqrt(hd)
    bf16 = route == "bf16"
    rnd = (lambda x: x.bfloat16().float()) if bf16 else (lambda x: x)   # noqa: E731

    def fold(x):                                          # [B,T,H,hd] -> [B,KVH,GT,hd]
        return x.reshape(B, T, KVH, G, hd).permute(0, 2, 3, 1, 4).reshape(B, KVH, GT, hd)
    qf, of, dof = fold(q), fold(o), fold(do)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)    # [B,KVH,L,hd]
    lsef = lse.reshape(B, KVH, GT)
    lse_safe = torch.where(torch.isinf(lsef), math.inf, lsef)   # a row that saw nothing: P = 0
    qpf = q_pos.repeat(1, G)                                     # [B, GT]: row g*T + t at t
    ok = ref._visible(qpf, k_pos, window, prefix_len)            # [B, GT, L]
    D = (dof * of).sum(-1)                                       # [B,KVH,GT] fp32

    # dQ: every 32-key tile in order (an invisible one adds exact zeros)
    dq = torch.zeros(B, KVH, GT, hd)
    for j0 in range(0, L, KEY_TILE):
        kt, vt = kf[:, :, j0:j0 + KEY_TILE], vf[:, :, j0:j0 + KEY_TILE]
        s = product("bkrd,bkjd->bkrj", qf, kt, route)
        dp = product("bkrd,bkjd->bkrj", dof, vt, route)
        p = torch.where(ok[:, None, :, j0:j0 + KEY_TILE],
                        torch.exp(s * scale - lse_safe[..., None]), 0.0)
        ds = rnd(p * (dp - D[..., None]))
        dq = dq + product("bkrj,bkjd->bkrd", ds, kt, route)
    dq = dq * scale

    # dK/dV: blocks of BWD_ROWS keys; each split sums its visible query
    # tiles in order into fp32 partials; the combine adds them in split order
    dk = torch.zeros(B, KVH, L, hd)
    dv = torch.zeros(B, KVH, L, hd)
    tq = K4.BWD_Q_TILE
    for b in range(B):
        for j0 in range(0, L, K4.BWD_ROWS):
            j1 = min(L, j0 + K4.BWD_ROWS)
            kp = np.full(K4.BWD_ROWS, -1)
            kp[:j1 - j0] = k_pos[b, j0:j1].numpy()
            vis = visible_q_tiles(qpf[b].numpy(), kp, window, prefix_len)
            kb, vb = kf[b, :, j0:j1], vf[b, :, j0:j1]            # [KVH, nk, hd]
            parts = []
            for c in range(splits):
                pk = torch.zeros(KVH, j1 - j0, hd)
                pv = torch.zeros(KVH, j1 - j0, hd)
                for t in split_share(vis, splits, c):
                    r = slice(t * tq, min(GT, t * tq + tq))
                    qt, ot = qf[b, :, r], dof[b, :, r]           # [KVH, nr, hd]
                    sT = product("kjd,krd->kjr", kb, qt, route)
                    dpT = product("kjd,krd->kjr", vb, ot, route)
                    lt = lse_safe[b, :, r][:, None, :]
                    pT = torch.where(ok[b, r, j0:j1].T[None], torch.exp(sT * scale - lt), 0.0)
                    dsT = pT * (dpT - D[b, :, r][:, None, :])
                    pv = pv + product("kjr,krd->kjd", rnd(pT), ot, route)
                    pk = pk + product("kjr,krd->kjd", rnd(dsT), qt, route)
                parts.append((pk, pv))
            sk, sv = parts[0]
            for pk, pv in parts[1:]:
                sk, sv = sk + pk, sv + pv
            dk[b, :, j0:j1] = sk * scale
            dv[b, :, j0:j1] = sv
    dq = dq.reshape(B, KVH, G, T, hd).permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)
    return rnd(dq), rnd(dk.permute(0, 2, 1, 3)), rnd(dv.permute(0, 2, 1, 3))


def run(name, route, splits, bf16=False, seed=0):
    q, k, v, do, pos, kw = make_case(name, bf16=bf16, seed=seed)
    o, lse = ref.flash_attn_fwd_lse_ref(q, k, v, pos, pos, **kw)
    if bf16:
        o = o.bfloat16().float()          # the kernel reads the bf16 forward output
    got = emulated_backward(q, k, v, o, do, lse, pos, pos, kw["window"], kw["prefix_len"],
                            route, splits)
    return got, (q, k, v, do, pos, kw, o, lse)


def rule_splits(name):
    B, T, KVH, G, _, _, _, _ = CASES[name]
    return K4.bwd_n_splits(B, KVH, G * T, T, SMS)


def autograd_grads(q, k, v, do, pos, kw):
    leaf = [x.clone().requires_grad_(True) for x in (q, k, v)]
    return torch.autograd.grad(ref.gqa_masked_ref(*leaf, pos, pos, **kw), leaf, do)


FP32_CASES = [(name, s) for name in CASES for s in (1, 2, 3, "rule")]


@pytest.mark.parametrize("name,splits", FP32_CASES)
def test_three_tf32_products_meet_the_fp32_grad_tolerance(name, splits):
    splits = rule_splits(name) if splits == "rule" else splits
    got, (q, k, v, do, pos, kw, o, lse) = run(name, "3xtf32", splits)
    explicit = ref.flash_attn_bwd_ref(q, k, v, o, do, lse, pos, pos, **kw)
    auto = autograd_grads(q, k, v, do, pos, kw)
    for g, e, a in zip(got, explicit, auto):
        assert excess(g, e, GRAD_TOL) <= 1.0
        assert excess(g, a, GRAD_TOL) <= 1.0
    if CASES[name][7] is not None:                  # the fully masked batch entry
        assert all(bool((g[1] == 0).all()) for g in got)


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_jax_vjp(name):
    """The emulated kernels, split as the rule splits them, against
    ``jax.vjp`` of the model's training attention."""
    got, (q, k, v, do, pos, kw, _, _) = run(name, "3xtf32", rule_splits(name), seed=1)
    jp = jnp.asarray(pos.numpy())
    _, vjp = jax.vjp(lambda a, b, c: jcm.flash_attention_train(a, b, c, jp, jp, block_q=8,
                                                               **kw),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do.numpy()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_with_p_and_ds_rounded_stays_within_the_bf16_rms_tolerance(name):
    got, (q, k, v, do, pos, kw, _, _) = run(name, "bf16", rule_splits(name), bf16=True)
    auto = autograd_grads(q, k, v, do, pos, kw)
    for g, a in zip(got, auto):
        rms = float((g - a).pow(2).mean().sqrt() / a.pow(2).mean().sqrt())
        assert rms <= BF16_RMS_TOL


@pytest.mark.parametrize("name", ["g2_causal_hd128", "g8_window_hd64"])
def test_one_tf32_product_misses_the_fp32_grad_tolerance(name):
    got, (q, k, v, do, pos, kw, o, lse) = run(name, "tf32", 1)
    explicit = ref.flash_attn_bwd_ref(q, k, v, o, do, lse, pos, pos, **kw)
    assert max(excess(g, e, GRAD_TOL) for g, e in zip(got, explicit)) > 2.0


@pytest.mark.parametrize("name", ["g8_causal_t70_hd128", "g7_causal_t37_hd128"])
def test_splits_change_only_the_rounding(name):
    """Splitting the dK/dV work moves sums between fp32 partials and
    nothing else: every split count agrees with the unsplit kernel to
    fp32 rounding, and dQ does not change at all."""
    (dq1, dk1, dv1), _ = run(name, "3xtf32", 1)
    for s in (2, 5):
        (dq, dk, dv), _ = run(name, "3xtf32", s)
        assert torch.equal(dq, dq1)
        for a, b in ((dk, dk1), (dv, dv1)):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---------------------------------------------------------------------------
# the fp32 operand permutation, lane by lane


def mma_m16n8k8(a_frag, b_frag, c_frag):
    """``mma.sync.m16n8k8.row.col`` on per-lane fragments (PTX layout:
    a = (g, t), (g+8, t), (g, t+4), (g+8, t+4); b = (t, g), (t+4, g);
    c = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); g = lane / 4, t = lane % 4)."""
    A, Bm, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[lane]
        Bm[t, g], Bm[t + 4, g] = b_frag[lane]
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = c_frag[lane]
    Dm = C + A @ Bm
    return [[Dm[lane // 4, 2 * (lane % 4)], Dm[lane // 4, 2 * (lane % 4) + 1],
             Dm[lane // 4 + 8, 2 * (lane % 4)], Dm[lane // 4 + 8, 2 * (lane % 4) + 1]]
            for lane in range(32)]


def two_products_fp32(a, b, n):
    """``two_products``' fp32 mapping: S = a b^T, a [16, hd] and b [n, hd]
    read as float2 at hd index 2t (slot t) and 2t+1 (slot t+4)."""
    hd = a.shape[1]
    s = [[[0.0] * 4 for _ in range(n // 8)] for _ in range(32)]
    for kk in range(hd // 8):
        for j in range(n // 8):
            af, bf = [], []
            for lane in range(32):
                g, d = lane // 4, kk * 8 + 2 * (lane % 4)
                af.append([a[g, d], a[g + 8, d], a[g, d + 1], a[g + 8, d + 1]])
                bf.append([b[j * 8 + g, d], b[j * 8 + g, d + 1]])
            res = mma_m16n8k8(af, bf, [s[lane][j] for lane in range(32)])
            for lane in range(32):
                s[lane][j] = res[lane]
    return s


def acc_product_fp32(x, y, hd):
    """``acc_product``'s fp32 mapping: acc = X Y with X in the accumulator
    fragments (its slots reordered into the A operand) and Y [k, hd] read at
    rows 2t and 2t+1."""
    kdim = len(x[0]) * 8
    acc = [[[0.0] * 4 for _ in range(hd // 8)] for _ in range(32)]
    for kk in range(kdim // 8):
        for j in range(hd // 8):
            af, bf = [], []
            for lane in range(32):
                g, t = lane // 4, lane % 4
                xk = x[lane][kk]
                af.append([xk[0], xk[2], xk[1], xk[3]])
                bf.append([y[kk * 8 + 2 * t, j * 8 + g], y[kk * 8 + 2 * t + 1, j * 8 + g]])
            res = mma_m16n8k8(af, bf, [acc[lane][j] for lane in range(32)])
            for lane in range(32):
                acc[lane][j] = res[lane]
    return acc


def from_fragments(frag, n):
    m = np.zeros((16, n))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j, c in enumerate(frag[lane]):
            m[g, j * 8 + 2 * t], m[g, j * 8 + 2 * t + 1] = c[0], c[1]
            m[g + 8, j * 8 + 2 * t], m[g + 8, j * 8 + 2 * t + 1] = c[2], c[3]
    return m


@pytest.mark.parametrize("hd,n", [(16, 32), (32, 16)])
def test_fp32_operand_permutation_computes_the_products(hd, n):
    """S = Q K^T (or K Q^T) from float2 reads, then dQ += dS K (or dV +=
    P^T dO) with the S fragments reused as the A operand and the B rows
    read in the order 2t, 2t+1: the kernel's fp32 mappings compute the
    matrix products exactly (fp64 here)."""
    rng = np.random.default_rng(hd + n)
    a, b = rng.standard_normal((16, hd)), rng.standard_normal((n, hd))
    s = two_products_fp32(a, b, n)
    np.testing.assert_allclose(from_fragments(s, n), a @ b.T, rtol=1e-12, atol=1e-12)
    y = rng.standard_normal((n, hd))
    acc = acc_product_fp32(s, y, hd)
    np.testing.assert_allclose(from_fragments(acc, hd), (a @ b.T) @ y, rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the query-tile scan and the split, as plain functions


@pytest.mark.parametrize("name", list(CASES))
def test_skipped_query_tiles_hold_no_visible_pair(name):
    """Every (query row, key) pair the mask lets through lies in a query
    tile the dK/dV scan keeps, for every key block."""
    B, T, KVH, G, _, window, prefix_len, lens = CASES[name]
    _, _, _, _, pos, _ = make_case(name)
    qpf = pos.repeat(1, G)
    ok = ref._visible(qpf, pos, window, prefix_len)                  # [B, GT, L]
    tq = K4.BWD_Q_TILE
    for b in range(B):
        for j0 in range(0, T, K4.BWD_ROWS):
            kp = np.full(K4.BWD_ROWS, -1)
            kp[:min(T, j0 + K4.BWD_ROWS) - j0] = pos[b, j0:j0 + K4.BWD_ROWS].numpy()
            vis = set(visible_q_tiles(qpf[b].numpy(), kp, window, prefix_len))
            rows = ok[b, :, j0:j0 + K4.BWD_ROWS].any(-1).nonzero().flatten().tolist()
            assert {r // tq for r in rows} <= vis


@pytest.mark.parametrize("n_vis,splits", [(0, 3), (1, 2), (5, 2), (16, 9), (18, 4), (40, 7)])
def test_split_shares_cover_the_visible_tiles_once_in_order(n_vis, splits):
    vis = list(range(3, 3 + 2 * n_vis, 2))
    shares = [split_share(vis, splits, c) for c in range(splits)]
    assert [t for sh in shares for t in sh] == vis
    assert max(len(sh) for sh in shares) <= -(-n_vis // splits) if n_vis else True


def test_causal_block_skips_the_tiles_above_the_diagonal():
    """Under a causal mask, the second 64-key block of a G = 1, T = 128 call
    keeps only the query tiles at or below it: 2 of 4."""
    pos = np.arange(128)
    assert visible_q_tiles(pos, pos[64:128], None, 0) == [2, 3]
    assert visible_q_tiles(pos, pos[0:64], None, 0) == [0, 1, 2, 3]
    assert visible_q_tiles(pos, pos[0:64], 16, 0) == [0, 1, 2]     # the window ends at 79
    assert visible_q_tiles(pos, pos[64:128], None, 70) == [0, 1, 2, 3]   # a prefix key


# ---------------------------------------------------------------------------
# the split rule, the workspace and the device kernels


def test_bwd_n_splits_depends_on_shapes_and_sm_count_only():
    assert list(inspect.signature(K4.bwd_n_splits).parameters) == [
        "B", "KVH", "rows", "L", "sms"]
    for B in (1, 2, 4, 8, 32):
        for KVH in (1, 4, 8, 32):
            for G in (1, 2, 7, 8, 10):
                for T in (16, 100, 128, 512, 2048):
                    for sms in (66, 132):
                        n = K4.bwd_n_splits(B, KVH, G * T, T, sms)
                        blocks = B * KVH * -(-T // K4.BWD_ROWS)
                        q_tiles = -(-G * T // K4.BWD_Q_TILE)
                        assert 1 <= n <= max(1, q_tiles // 2)
                        if 2 * blocks >= sms:
                            assert n == 1
                        else:   # about a block an SM, unless a split would get under two tiles
                            assert (abs(n * blocks - sms) <= blocks / 2
                                    or n == max(1, q_tiles // 2))


@pytest.mark.parametrize("shape,want", [
    ((8, 8, 2 * 128, 128), 1),     # the trainer: 128 (key tile, kv-head, b) blocks
    ((8, 12, 128, 128), 1),        # the OPT-125M distillation: 192 blocks
    ((2, 4, 8 * 128, 128), 8),     # gqa_g8: 16 blocks
    ((2, 4, 10 * 128, 128), 8),    # gqa_g10
    ((2, 8, 7 * 100, 100), 4),     # gqa_g7: 32 blocks
    ((2, 8, 2 * 160, 160), 3),     # window_48: 48 blocks
    ((4, 8, 4 * 128, 128), 2),     # G = 4 at B 4: 64 blocks
])
def test_bwd_n_splits_at_phase_2c_shapes(shape, want):
    assert K4.bwd_n_splits(*shape, SMS) == want


def test_bwd_workspace_and_device_kernels():
    assert K4.bwd_workspace_floats(2, 4, 128, 128, 1) == 0
    assert K4.bwd_workspace_floats(2, 4, 128, 128, 3) == 2 * 3 * 2 * 128 * 4 * 128
    assert K4.bwd_device_kernels(1) == 2 and K4.bwd_device_kernels(4) == 3


def _stand_in_for_the_card(monkeypatch, calls):
    def fake_invoke(entry, dev, *args):
        calls.append(args)
        return 0
    monkeypatch.setattr(K4, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K4, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(K4, "invoke", fake_invoke)
    # the stand-in calls count; give the count back afterwards, since other
    # files hold that nothing launched in their worker
    monkeypatch.setattr(K4.BWD, "launches", K4.BWD.launches)


def _aligned(x):
    """A copy of ``x`` in a fresh (64-byte aligned) allocation."""
    out = torch.empty(x.shape, dtype=x.dtype)
    out.copy_(x)
    return out


def _bwd_inputs(name):
    q, k, v, do, pos, kw = make_case(name)
    o, lse = ref.flash_attn_fwd_lse_ref(q, k, v, pos, pos, **kw)
    return [_aligned(x) for x in (q, k, v, o, do)] + [lse, pos], kw


@pytest.mark.parametrize("name", ["g8_causal_t70_hd128", "g2_padded_masked_hd64"])
def test_wrapper_hands_the_kernel_a_geometry_of_shapes_only(monkeypatch, name):
    """The split count and the workspace come from the shapes: positions
    that hide every key, or none, give the same launch; a call counts once
    although it may issue three device kernels."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    (q, k, v, o, do, lse, pos), kw = _bwd_inputs(name)
    before = K4.BWD.launches
    for p in (pos, torch.full_like(pos, -1), torch.zeros_like(pos)):
        dq, dk, dv = K4.flash_attn_bwd_cuda(q, k, v, o, do, lse, p, p, **kw)
        assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert K4.BWD.launches == before + 3
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    splits = K4.bwd_n_splits(B, KVH, (H // KVH) * T, T, SMS)
    # (dtype, q, k, v, o, do, lse, q_pos, k_pos, dsum, dq, dk, dv, ws, n_splits,
    #  B, T, H, KVH, L, hd, ...)
    geometry = {(a[13] is not None,) + tuple(a[14:21]) for a in calls}
    assert geometry == {(splits > 1, splits, B, T, H, KVH, T, hd)}
    assert {a[0] for a in calls} == {0}


@pytest.mark.parametrize("which", ["q", "k", "o", "do"])
def test_wrapper_rejects_unaligned_copies(monkeypatch, which):
    """16-byte copies need 16-byte bases: the backward raises before any
    launch, with no other route."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    (q, k, v, o, do, lse, pos), kw = _bwd_inputs("g2_causal_hd128")
    t = dict(q=q, k=k, o=o, do=do)[which]
    flat = torch.zeros(t.numel() + 1)
    off = flat[1:].view(t.shape)                      # 4 bytes past a 16-byte boundary
    off.copy_(t)
    args = dict(q=q, k=k, v=v, o=o, do=do)
    args[which] = off
    launches = K4.BWD.launches
    with pytest.raises(ValueError, match="16 bytes"):
        K4.flash_attn_bwd_cuda(args["q"], args["k"], args["v"], args["o"], args["do"], lse,
                               pos, pos, **kw)
    assert K4.BWD.launches == launches and not calls


@pytest.mark.parametrize("dtype,hd", [(torch.float64, 128), (torch.float32, 96),
                                      (torch.bfloat16, 256)])
def test_backward_occupancy_query_rejects_what_has_no_instantiation(dtype, hd):
    """The backward's occupancy query checks (dtype, hd) before it loads the
    library; only fp32/bf16 at hd 64 and 128 have a backward."""
    with pytest.raises(ValueError, match="no backward"):
        K4.bwd_occupancy(dtype, hd)
