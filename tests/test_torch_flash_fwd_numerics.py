"""The arithmetic of K4's forward kernel (``csrc/flash_attn.cu``), emulated
on the CPU and held against the port's plain forward
``ref.flash_attn_fwd_lse_ref`` at the tolerances ``chip_smoke.py`` holds
the kernel to on the card (phase 2c: 1e-5 absolute plus relative in fp32,
1e-2 in bf16).

The kernel multiplies on the tensor cores.  In fp32 it splits each operand
into a large and a small tf32 part (``big = tf32(x)``, ``small =
tf32(x - big)``) and sums three products, big*big + big*small + small*big,
for Q K^T and for P V; in bf16 it rounds P to bf16 before P V.  The
emulation rounds the operands as the kernel does (tf32 as ``cvt.rna``:
to nearest, ties away from zero, on the magnitude), runs the kernel's
online softmax over its 32-key tiles (in both dtypes), and sums
the exact products in fp32.  It does not model the tensor cores'
accumulation order or how they round partial sums; ``chip_smoke.py``
checks those on the card.

The cases: B 2, T 64, 16 query heads over 8 kv-heads, hd 64, 128 and 256,
and MLA's q/k head dim 192 with v head dim 128 (the kernel's (192, 128)
instantiation: scores over 192 columns, the output over 128); causal, a
window of 16, and right padding with a fully masked batch entry; and
paligemma-3b's prefill at hd 256 (B 1, T 288, 8 heads over 1 kv-head)
behind a bidirectional prefix of 256 positions.  A separate test models
the kernel's scan of key tiles for each block of 64 folded rows
(:func:`loaded_tiles`: a block of early positions loads every prefix tile
past them) and checks that no visible key lies in a tile it skips.
Inputs are made with numpy from a seed.  The test that a single tf32
product misses the fp32 tolerance is the recorded reason for the split.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

FP32_TOL = 1e-5   # phase 2c's fp32 tolerance, absolute plus relative
BF16_TOL = 1e-2   # phase 2c's bf16 tolerance
TILE_KEYS = 32   # the kernel's key tile, fp32 and bf16

MASKS = {"causal": dict(window=None, lens=None),
         "window": dict(window=16, lens=None),
         "padded": dict(window=None, lens=[41, 0]),   # batch entry 1 fully masked
         # paligemma-3b's prefill: a 256-position bidirectional prefix, then
         # 32 prompt rows, the last 7 of them padding
         "prefix256": dict(window=None, lens=[281], prefix_len=256,
                           shape=dict(B=1, T=288, H=8, KVH=1))}
FBQ = 64         # folded query rows of a forward block


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> tf32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` with the kernel's operand rounding; the products
    of tf32 or bf16 values are exact in fp32."""
    if route == "3xtf32":
        ab, bb = tf32(a), tf32(b)
        as_, bs = tf32(a - ab), tf32(b - bb)
        return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
                + torch.einsum(eq, ab, bb))
    if route == "tf32":
        return torch.einsum(eq, tf32(a), tf32(b))
    return torch.einsum(eq, a, b)        # bf16: operands are bf16 values already


def loaded_tiles(q_pos, k_pos, G, window, prefix_len):
    """The keys the kernel loads for each folded row, ``[B, G, T, L]``: per
    block of ``FBQ`` folded rows ``g*T + t``, the key tiles that some row of
    the block may see (``next_tile``'s scan: a key at or below the block's
    last position, inside the window of its first, or in the prefix)."""
    B, T = q_pos.shape
    L = k_pos.shape[1]
    out = torch.zeros((B, G * T, L), dtype=torch.bool)
    for b in range(B):
        for r0 in range(0, G * T, FBQ):
            qp = q_pos[b, torch.arange(r0, min(r0 + FBQ, G * T)) % T]
            qhi = int(qp.max())
            qlo = int(qp[qp >= 0].min()) if bool((qp >= 0).any()) else 2**31 - 1
            kp = k_pos[b]
            may = (kp >= 0) & (kp <= qhi)
            if window is not None:
                may &= kp > qlo - window
            if prefix_len:
                may |= (kp >= 0) & (kp < prefix_len)
            tiles = torch.stack([may[j:j + TILE_KEYS].any() for j in range(0, L, TILE_KEYS)])
            out[b, r0:r0 + FBQ] = tiles.repeat_interleave(TILE_KEYS)[:L]
    return out.view(B, G, T, L)


def emulated_forward(q, k, v, q_pos, k_pos, window, route, prefix_len=0):
    """K4's forward as the kernel computes it, up to summation order: per
    (b, kv-head) the G heads' rows against key tiles, online softmax with
    the finite-max guard, ``out = acc / max(l, 1e-30)``, ``lse = m + log l``
    (-inf where no key was seen).  q/k have dk columns, v dv: the scores
    run over dk at scale 1/sqrt(dk), the output over dv.  Returns (out
    [B,T,H,dv], lse [B,H,T])."""
    B, T, H, hd = q.shape
    L, KVH, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, T, KVH, G, hd).permute(0, 2, 3, 1, 4)            # [B,KVH,G,T,hd]
    ok = ref._visible(q_pos, k_pos, window, prefix_len)[:, None, None]  # [B,1,1,T,L]
    m = torch.full((B, KVH, G, T), -math.inf)
    l = torch.zeros((B, KVH, G, T))
    acc = torch.zeros((B, KVH, G, T, dv))
    for j0 in range(0, L, TILE_KEYS):
        kt = k[:, j0:j0 + TILE_KEYS].permute(0, 2, 1, 3)                 # [B,KVH,tile,hd]
        vt = v[:, j0:j0 + TILE_KEYS].permute(0, 2, 1, 3)
        s = product("bkgtd,bkjd->bkgtj", qf, kt, route) * scale
        s = torch.where(ok[..., j0:j0 + TILE_KEYS], s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.where(m == -math.inf, 0.0, torch.exp(m - m_safe))
        p = torch.exp(s - m_safe[..., None])
        l = l * corr + p.sum(-1)
        if route == "bf16":
            p = p.bfloat16().float()
        acc = acc * corr[..., None] + product("bkgtj,bkjd->bkgtd", p, vt, route)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l), -math.inf)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, dv)
    if route == "bf16":
        out = out.bfloat16().float()
    return out, lse.reshape(B, H, T)


def make_inputs(hd, mask, bf16=False, seed=0):
    """q, k, v, positions and window of a case; ``hd`` is one head dim, or
    a (dk, dv) pair."""
    B, T, H, KVH = MASKS[mask].get("shape", dict(B=2, T=64, H=16, KVH=8)).values()
    dk, dv = hd if isinstance(hd, tuple) else (hd, hd)
    rng = np.random.default_rng(seed + dk)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, T, H, dk), (B, T, KVH, dk), (B, T, KVH, dv)))
    if bf16:
        q, k, v = (x.bfloat16().float() for x in (q, k, v))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    lens = MASKS[mask]["lens"]
    if lens is not None:
        pos = np.where(pos < np.array(lens)[:, None], pos, -1).astype(np.int32)
    return q, k, v, torch.from_numpy(pos), MASKS[mask]["window"]


def excess(got, want, tol):
    """The largest ``|got - want| / (tol + tol |want|)`` (at most 1 means
    within tolerance, as ``chip_smoke.within``); -inf must match exactly."""
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and bool((got[inf] == want[inf]).all())
    err = (got[~inf] - want[~inf]).abs() / (tol + tol * want[~inf].abs())
    return float(err.max())


CASES = [(hd, mask) for hd in (64, 128, 256) for mask in MASKS
         if mask != "prefix256" or hd == 256] + [
    pytest.param((192, 128), mask, id=f"192x128-{mask}") for mask in MASKS
    if mask != "prefix256"]


def _prefix(mask):
    return MASKS[mask].get("prefix_len", 0)


@pytest.mark.parametrize("hd,mask", CASES)
def test_three_tf32_products_meet_the_fp32_tolerance(hd, mask):
    q, k, v, pos, window = make_inputs(hd, mask)
    out, lse = emulated_forward(q, k, v, pos, pos, window, "3xtf32", _prefix(mask))
    want, want_lse = ref.flash_attn_fwd_lse_ref(q, k, v, pos, pos, window=window,
                                                prefix_len=_prefix(mask))
    assert excess(out, want, FP32_TOL) <= 1.0
    assert excess(lse, want_lse, FP32_TOL) <= 1.0
    masked = pos < 0
    if not _prefix(mask):        # a padded row sees the prefix, as in the reference
        assert bool((out[masked] == 0).all())
    if mask == "padded":
        assert bool(torch.isinf(lse[1]).all())       # the fully masked batch entry


@pytest.mark.parametrize("hd,mask", CASES)
def test_one_tf32_product_misses_the_fp32_tolerance(hd, mask):
    q, k, v, pos, window = make_inputs(hd, mask)
    out, _ = emulated_forward(q, k, v, pos, pos, window, "tf32", _prefix(mask))
    want, _ = ref.flash_attn_fwd_lse_ref(q, k, v, pos, pos, window=window,
                                         prefix_len=_prefix(mask))
    assert excess(out, want, FP32_TOL) > 2.0


@pytest.mark.parametrize("hd,mask", CASES)
def test_bf16_with_p_rounded_before_pv_meets_the_bf16_tolerance(hd, mask):
    q, k, v, pos, window = make_inputs(hd, mask, bf16=True)
    out, lse = emulated_forward(q, k, v, pos, pos, window, "bf16", _prefix(mask))
    want, want_lse = ref.flash_attn_fwd_lse_ref(q, k, v, pos, pos, window=window,
                                                prefix_len=_prefix(mask))
    assert excess(out, want, BF16_TOL) <= 1.0
    assert excess(lse, want_lse, BF16_TOL) <= 1.0


def test_the_prefix_case_skips_tiles_and_loads_the_prefix_for_early_rows():
    """The premise of the prefix case: the first block (positions 0-63 of
    head 0) loads all 8 prefix tiles though its rows end at 63, later
    blocks skip the tiles past their last position, and no (query, key)
    pair the mask lets through lies in a skipped tile."""
    _, _, _, pos, window = make_inputs(256, "prefix256")
    loaded = loaded_tiles(pos, pos, 8, window, 256)                      # [B, G, T, L]
    ok = ref._visible(pos, pos, window, 256)                             # [B, T, L]
    assert not bool((ok[:, None] & ~loaded).any())
    tiles = loaded[0, 0, :, ::TILE_KEYS]                                 # [T, tiles]
    assert bool(tiles[:64, :8].all()) and not bool(tiles[:64, 8:].any())
    assert bool(tiles[256:, :].all()) and not bool(loaded.all())


def test_tf32_rounding_is_to_nearest_ties_away_and_the_split_keeps_21_bits():
    one = 1.0
    half_ulp = 2.0 ** -11                           # tf32 keeps 10 bits after the point
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0 ** -23,
                      3.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one, 3.0, 0.0, -0.0])
    assert torch.equal(tf32(x), want)
    assert torch.equal(torch.signbit(tf32(x)), torch.signbit(want))
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    assert bool(((tf32(ab) == ab) & (tf32(as_) == as_)).all())
    assert float(((ab + as_ - a).abs() / a.abs()).max()) <= 2.0 ** -21
    exact = a.double() * b.double()
    three = (ab.double() * bb.double() + ab.double() * bs.double()
             + as_.double() * bb.double())
    assert float(((three - exact).abs() / exact.abs()).max()) <= 2.0 ** -20
