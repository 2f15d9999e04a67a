"""The arithmetic of K1, the verify-attention kernel (``csrc/spec_verify_attn.cu``),
emulated on the CPU and held against the port's plain version
``ref.gqa_masked_ref`` at the tolerances ``chip_smoke.py`` holds the kernel
to on the card (phase 2: 1e-5 absolute plus relative in fp32, 1e-2 in bf16),
and against the JAX package's ``spec_verify_attn_pallas`` in interpret mode.

The kernel multiplies on the tensor cores: in fp32 as three tf32 products
(big*big + big*small + small*big, tf32 rounded as ``cvt.rna``), in bf16
with P rounded to bf16 before P V.  The emulation follows its algorithm:
the row tile the wrapper picks (16 or 64 folded rows ``g*T + t``), the
32-key tiles, the visibility test on positions that skips a tile no row of
the tile can see (and drops the mask on a tile every row sees whole), the
split of the ordered visible tiles over ``n_splits`` blocks, each split's
online softmax with the ``m_safe`` guard, the combine in split order, and
int8 k/v dequantised tile by tile as ``x * scale`` in fp32 rounded to the
query's type.  It does not model the tensor cores' summation order or the
hardware exp; the card's phase 2 checks those.

Also here: the wrapper's row tile, split rule and workspace size as plain
functions, and what the wrapper hands the C entry point (the device is
stood in for).  Inputs are made with numpy from a seed.
"""
import functools
import inspect
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import launch, ref
from repro_torch.kernels import spec_verify_attn as K1
from test_torch_flash_fwd_numerics import product
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

FP32_TOL = 1e-5   # phase 2's fp32 tolerance, absolute plus relative
BF16_TOL = 1e-2   # phase 2's bf16 tolerance
INT_MAX = 2**31 - 1
SMS = 132         # an H100's SMs


def make_case(B, T, L, H, KVH, hd=64, *, n_ctx, window=None, prefix_len=0,
              masked=False, quant=False, seed=0):
    """Ring-cache inputs as the serving path gives them: per request a
    context length n (ragged over the batch), T queries at n-1 .. n+T-2, the
    cache rows holding the newest L positions below n+T-1 (-1 unwritten);
    ``masked`` sets every query of request 0 to -1.  int8 k/v come with
    per-(row, kv-head) scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    n = np.array([max(1, n_ctx - 7 * b) for b in range(B)])
    q_pos = (n[:, None] - 1 + np.arange(T)[None]).astype(np.int32)
    top = (n + T - 1)[:, None]
    rows = np.arange(L)[None]
    cand = rows + (np.maximum(top - 1 - rows, 0) // L) * L
    k_pos = np.where(cand < top, cand, -1).astype(np.int32)
    if masked:
        q_pos[0, :] = -1
    ks = vs = None
    if quant:
        ks = (np.abs(k).max(-1) / 127.0 + 1e-8).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0 + 1e-8).astype(np.float32)
        k = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    return dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos, k_scale=ks, v_scale=vs,
                window=window, prefix_len=prefix_len)


def torch_inputs(c, bf16):
    """The case as the kernel's operands: q (and k/v, scales) rounded to
    bf16 for the bf16 route; int8 k/v dequantised as the kernel does."""
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in c.items()}
    rnd = (lambda x: x.bfloat16().float()) if bf16 else (lambda x: x)
    q = rnd(t["q"])
    if t["k_scale"] is not None:
        ks, vs = rnd(t["k_scale"]), rnd(t["v_scale"])
        k = rnd(t["k"].float() * ks[..., None])
        v = rnd(t["v"].float() * vs[..., None])
    else:
        k, v = rnd(t["k"]), rnd(t["v"])
    return q, k, v, t["q_pos"], t["k_pos"]


def tile_masks(kp, qp, window, prefix_len):
    """The kernel's scan over 32-key tiles of one request: which tiles some
    row of the tile's positions ``qp`` may see, and which every row sees
    whole."""
    qhi = int(qp.max())
    qlo = int(qp[qp >= 0].min()) if bool((qp >= 0).any()) else INT_MAX
    qmin = int(qp.min())
    L = kp.shape[0]
    vis, full = [], []
    for j0 in range(0, L, K1.KEY_TILE):
        x = kp[j0:j0 + K1.KEY_TILE]
        v = (x >= 0) & (x <= qhi)
        if window is not None:
            v &= x > qlo - window
        if prefix_len:
            v |= (x >= 0) & (x < prefix_len)
        f = (x >= 0) & (x <= qmin)
        if window is not None:
            f &= x > qhi - window
        vis.append(bool(v.any()))
        full.append(qmin >= 0 and len(x) == K1.KEY_TILE and bool(f.all()))
    return vis, full


def split_tiles(vis, splits):
    """Split c's tiles: [c*P, c*P + P) of the ordered visible list."""
    order = [t for t, v in enumerate(vis) if v]
    per = -(-len(order) // splits)
    return [order[c * per:(c + 1) * per] for c in range(splits)]


def emulate(q, k, v, q_pos, k_pos, window, prefix_len, route, splits=None):
    """K1 as the kernel computes it, up to summation order and the hardware
    exp.  Returns [B,T,H,hd] (rounded to bf16 on the bf16 route)."""
    B, T, H, hd = q.shape
    L, KVH = k.shape[1], k.shape[2]
    G, rows = H // KVH, (H // KVH) * T
    rt = K1.row_tile(rows)
    n = splits or K1.n_splits(B, KVH, rows, L, SMS, hd)
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros(B, T, H, hd)
    for b in range(B):
        for kvh in range(KVH):
            for r0 in range(0, rows, rt):
                fr = torch.arange(r0, min(r0 + rt, rows))
                heads, times = kvh * G + fr // T, fr % T
                qr, qp = q[b, times, heads], q_pos[b, times]                # [nr, hd], [nr]
                vis, full = tile_masks(k_pos[b], qp, window, prefix_len)
                parts = []
                for tiles in split_tiles(vis, n):
                    m = torch.full((len(fr),), -math.inf)
                    l, acc = torch.zeros(len(fr)), torch.zeros(len(fr), hd)
                    for t in tiles:
                        sl = slice(t * K1.KEY_TILE, (t + 1) * K1.KEY_TILE)
                        kt, vt, kp = k[b, sl, kvh], v[b, sl, kvh], k_pos[b, sl]
                        s = product("rd,jd->rj", qr, kt, route) * scale
                        ok = ref._visible(qp, kp, window, prefix_len)
                        if full[t]:
                            assert bool(ok.all())          # a full tile needs no mask
                        s = torch.where(ok, s, -math.inf)
                        m_new = torch.maximum(m, s.amax(-1))
                        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
                        corr = torch.where(m == -math.inf, 0.0, torch.exp(m - m_safe))
                        p = torch.exp(s - m_safe[:, None])
                        l = l * corr + p.sum(-1)
                        if route == "bf16":
                            p = p.bfloat16().float()
                        acc = acc * corr[:, None] + product("rj,jd->rd", p, vt, route)
                        m = m_new
                    parts.append((acc, m, l))
                if n == 1:
                    acc, _, l = parts[0]
                    res = acc / l.clamp(min=1e-30)[:, None]
                else:                                   # the combine, in split order
                    M = torch.stack([m for _, m, _ in parts]).amax(0)
                    Ms = torch.where(M == -math.inf, 0.0, M)
                    A, Lsum = torch.zeros(len(fr), hd), torch.zeros(len(fr))
                    for acc, m, l in parts:
                        f = torch.where(m == -math.inf, 0.0, torch.exp(m - Ms))
                        A, Lsum = A + f[:, None] * acc, Lsum + f * l
                    res = A / Lsum.clamp(min=1e-30)[:, None]
                out[b, times, heads] = res
    return out.bfloat16().float() if route == "bf16" else out


def within(got, want, tol):
    err = (got - want).abs()
    return bool((err <= tol + tol * want.abs()).all()), float(err.max())


# (B, T, L, H, KVH, make_case keywords): a grid of T, G and L (decode, verify
# and prefill; one or more row tiles; one or two key tiles), and the
# contract's variants
GRID = {f"t{T}_g{G}_l{L}": (2, T, L, 2 * G, 2, dict(n_ctx=L - 5))
        for T in (1, 5, 37) for G in (1, 4, 7) for L in (40, 64)}
VARIANTS = {
    "window_wrapped": (2, 5, 64, 4, 2, dict(n_ctx=150, window=20)),
    "prefix": (2, 5, 64, 4, 2, dict(n_ctx=60, prefix_len=6)),
    "window_prefix": (3, 4, 64, 2, 2, dict(n_ctx=140, window=9, prefix_len=5)),
    "masked_row": (2, 5, 40, 4, 2, dict(n_ctx=35, masked=True)),
    "int8": (2, 5, 64, 8, 2, dict(n_ctx=60, quant=True)),
    "long_ring": (1, 3, 256, 2, 2, dict(n_ctx=700, window=150)),
    # paligemma-3b's head dim 256 behind its bidirectional prefix of 256
    # positions, 8 key tiles that rows before them see: a B 1 prefill (the
    # early row tiles see key tiles past their own positions), a verify
    # over 512 rows at 8 heads a kv-head, and the same over int8 k/v
    "hd256_prefill_prefix256": (1, 300, 320, 2, 1, dict(hd=256, n_ctx=1, prefix_len=256)),
    "hd256_verify_prefix256": (2, 4, 512, 8, 1, dict(hd=256, n_ctx=420, prefix_len=256)),
    "hd256_int8_prefix256": (1, 4, 512, 8, 1, dict(hd=256, n_ctx=300, prefix_len=256,
                                                     quant=True)),
}
CASES = {**GRID, **VARIANTS}


def case(name, seed=0):
    B, T, L, H, KVH, kw = CASES[name]
    return make_case(B, T, L, H, KVH, seed=seed + len(name), **kw)


@pytest.mark.parametrize("splits", [1, 2, 3, None], ids=["1", "2", "3", "rule"])
@pytest.mark.parametrize("route", ["3xtf32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_meets_the_phase2_tolerance(name, route, splits):
    """Every row tile, split count (more splits than visible tiles leaves
    some empty) and route within the card's tolerance of the plain version;
    fully masked rows exact zeros."""
    c = case(name)
    bf16 = route == "bf16"
    q, k, v, qp, kp = torch_inputs(c, bf16)
    got = emulate(q, k, v, qp, kp, c["window"], c["prefix_len"], route, splits)
    want = ref.gqa_masked_ref(q, k, v, qp, kp, c["window"], c["prefix_len"])
    if bf16:
        want = want.bfloat16().float()
    ok, err = within(got, want, BF16_TOL if bf16 else FP32_TOL)
    assert ok, err
    if not c["prefix_len"]:
        assert bool((got[qp < 0] == 0).all())


def test_one_tf32_product_misses_the_fp32_tolerance():
    """Why fp32 takes three tf32 products: one keeps 10 bits and misses."""
    c = make_case(2, 9, 64, 8, 2, hd=128, n_ctx=60, seed=5)
    q, k, v, qp, kp = torch_inputs(c, False)
    got = emulate(q, k, v, qp, kp, None, 0, "tf32")
    want = ref.gqa_masked_ref(q, k, v, qp, kp)
    ok, err = within(got, want, FP32_TOL)
    assert not ok and err > 2 * FP32_TOL


def _pallas(c):
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    fn = jax.jit(functools.partial(jops.spec_verify_attn, block_k=16, use_pallas=True,
                                   window=c["window"], prefix_len=c["prefix_len"]))
    return torch.from_numpy(np.array(fn(j(c["q"]), j(c["k"]), j(c["v"]), j(c["q_pos"]),
                                          j(c["k_pos"]), k_scale=j(c["k_scale"]),
                                          v_scale=j(c["v_scale"]))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_the_pallas_kernel(name):
    """The fp32 route, with the wrapper's split count and with two splits,
    against the JAX package's ``spec_verify_attn_pallas`` (interpret mode)
    on the same numpy inputs, within the card's fp32 tolerance."""
    c = case(name, seed=1)
    want = _pallas(c)
    q, k, v, qp, kp = torch_inputs(c, False)
    for splits in (None, 2):
        got = emulate(q, k, v, qp, kp, c["window"], c["prefix_len"], "3xtf32", splits)
        ok, err = within(got, want, FP32_TOL)
        assert ok, (splits, err)


def test_the_window_case_skips_tiles_and_marks_full_ones():
    """The premise of the ring variants: on a wrapped ring with a window
    some tiles are skipped before any byte moves, and a tile every row sees
    whole takes no mask."""
    c = case("long_ring")
    kp, qp = torch.from_numpy(c["k_pos"][0]), torch.from_numpy(c["q_pos"][0])
    vis, full = tile_masks(kp, qp, c["window"], 0)
    assert 0 < sum(vis) < len(vis)
    assert any(full)
    assert all(v for v, f in zip(vis, full) if f)


def test_the_prefix_case_loads_the_prefix_tiles_for_every_row_tile():
    """The premise of the hd 256 prefill: a row tile whose positions lie
    below the prefix's end still loads every prefix tile (a causal scan
    would skip those past its last position) and no tile past its rows;
    no tile with a prefix key it cannot see causally is marked full."""
    c = case("hd256_prefill_prefix256")
    kp, qp_all = torch.from_numpy(c["k_pos"][0]), torch.from_numpy(c["q_pos"][0])
    T, rt = qp_all.shape[0], K1.row_tile(2 * qp_all.shape[0])
    for r0 in range(0, 2 * T, rt):
        qp = qp_all[torch.arange(r0, min(r0 + rt, 2 * T)) % T]
        vis, full = tile_masks(kp, qp, None, 256)
        last = int(qp.max()) // K1.KEY_TILE
        assert vis == [t < 8 or t <= last for t in range(len(vis))], r0
        assert not any(f for t, f in enumerate(full) if t * K1.KEY_TILE + 31 > int(qp.min()))
    assert K1.row_tile(600) == 64


@pytest.mark.parametrize("rows,want", [(1, 16), (9, 16), (16, 16), (17, 64), (28, 64),
                                       (256, 64), (700, 64)])
def test_row_tile_is_picked_from_the_folded_rows(rows, want):
    assert K1.row_tile(rows) == want
    assert K1.row_tiles(rows) == -(-rows // want)


def test_n_splits_depends_on_shapes_and_sm_count_only():
    assert list(inspect.signature(K1.n_splits).parameters) == [
        "B", "KVH", "rows", "L", "sms", "hd"]
    for B, KVH, rows, L, sms, hd in itertools.product(
            (1, 2, 4, 8, 16), (1, 4, 8, 12, 32), (1, 4, 9, 16, 28, 64, 256, 700),
            (40, 256, 512, 1024, 4096), (66, 132), (64, 128, 256)):
        n = K1.n_splits(B, KVH, rows, L, sms, hd)
        blocks = B * KVH * K1.row_tiles(rows)
        table = K1.SPLIT_MIN_TILES_HD256 if hd == 256 else K1.SPLIT_MIN_TILES
        cap = -(-L // K1.KEY_TILE) // table[K1.row_tile(rows)]
        assert 1 <= n <= max(1, cap)
        if blocks >= sms:
            assert n == 1
        elif n < max(1, cap):   # else two blocks an SM
            assert n * blocks >= 2 * sms


@pytest.mark.parametrize("shape,want", [
    ((8, 32, 4, 256, 128), 1),     # target verify at s = 3 (phase 4): 256 blocks
    ((8, 12, 1, 256, 64), 1),      # the draft's decode at B 8: no split pays at L 256
    ((1, 32, 256, 512, 128), 1),   # phase 6b's largest target prefill
    ((1, 12, 64, 512, 64), 1),     # phase 6b's smallest draft prefill
    ((1, 32, 1, 512, 128), 2),     # a B = 1 decode near the end of a 512-row ring
    ((1, 32, 1, 4096, 128), 9),    # ... of a 4096-row one: two blocks an SM
    ((1, 32, 256, 1024, 128), 2),  # a prefill chunk over 1024 rows
    ((1, 32, 256, 4096, 128), 3),
    ((16, 1, 32, 512, 256), 4),    # paligemma-3b's verify at s 3 (phase 12b's rings)
    ((1, 1, 3072, 512, 256), 4),   # its B 1 prefill of 384 rows (prefill_into)
    ((16, 1, 3072, 512, 256), 1),  # its B 16 prefill: 768 blocks
    ((1, 1, 8, 2048, 256), 16),    # one request decoding near the end of 2048 rows
])
def test_n_splits_at_phase_2_shapes(shape, want):
    assert K1.n_splits(*shape[:4], SMS, shape[4]) == want


def test_workspace_and_device_kernels():
    B, KVH, rows, hd = 1, 32, 256, 128
    assert K1.workspace_floats(B, KVH, rows, hd, 3) == B * KVH * 3 * 4 * 64 * (hd + 2)
    assert K1.workspace_floats(2, 8, 5, 64, 2) == 2 * 8 * 2 * 1 * 16 * (64 + 2)
    assert launch.device_kernels(1) == 1 and launch.device_kernels(4) == 2


def _stand_in_for_the_card(monkeypatch, calls):
    def fake_invoke(entry, dev, *args):
        calls.append(args)
        return 0
    monkeypatch.setattr(K1, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K1, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(K1, "invoke", fake_invoke)
    # the stand-in calls count; give the count back afterwards, since other
    # files hold that nothing launched in their worker
    monkeypatch.setattr(K1.KERNEL, "launches", K1.KERNEL.launches)


@pytest.mark.parametrize("name,L", [("b8_verify", 256), ("b1_decode", 512),
                                    ("b1_prefill", 1024)])
def test_wrapper_hands_the_kernel_a_geometry_of_shapes_only(monkeypatch, name, L):
    """Row tile, split count and workspace come from the shapes: positions
    that hide every key, or none, give the same launch; a call counts once
    although it may issue two device kernels."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    B, T = {"b8_verify": (8, 4), "b1_decode": (1, 1), "b1_prefill": (1, 100)}[name]
    c = make_case(B, T, L, 4, 4, hd=64, n_ctx=L - 3)
    q, k, v, qp, kp = (torch.from_numpy(c[x]) for x in ("q", "k", "v", "q_pos", "k_pos"))
    before = K1.KERNEL.launches
    for kpos in (kp, torch.full_like(kp, -1), torch.zeros_like(kp)):
        K1.spec_verify_attn_cuda(q, k, v, qp, kpos)
    assert K1.KERNEL.launches == before + 3
    rows = T
    splits = K1.n_splits(B, 4, rows, L, SMS, 64)
    # (q_dtype, kv_dtype, 8 pointers, B, T, H, KVH, L, hd, row_tile, n_splits, ws, ...)
    geometry = {tuple(a[10:18]) + (a[18] is not None,) for a in calls}
    assert geometry == {(B, T, 4, 4, L, 64, K1.row_tile(rows), splits, splits > 1)}


def test_wrapper_rejects_unaligned_copies(monkeypatch):
    """16-byte copies need 16-byte bases and (b, l) strides: the wrapper
    raises before any launch, with no other route."""
    calls = []
    _stand_in_for_the_card(monkeypatch, calls)
    c = make_case(2, 3, 40, 4, 2, hd=64, n_ctx=30)
    q, k, v, qp, kp = (torch.from_numpy(c[x]) for x in ("q", "k", "v", "q_pos", "k_pos"))
    flat = torch.zeros(k.numel() + 1)
    k_off = flat[1:].view(k.shape)                    # 4 bytes past a 16-byte boundary
    k_off.copy_(k)
    launches = K1.KERNEL.launches
    with pytest.raises(ValueError, match="16 bytes"):
        K1.spec_verify_attn_cuda(q, k_off, v, qp, kp)
    assert K1.KERNEL.launches == launches and not calls
