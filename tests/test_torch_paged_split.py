"""The split-KV arithmetic of the paged verify kernels K2 and K3
(``csrc/paged_verify_attn.cu``), emulated in fp32 torch on the CPU.

The kernels split each slot's key range across blocks: split ``c`` takes
live blocks ``[c*P, (c+1)*P)`` of the slot's ordered list of live blocks
(``P = ceil(MAXB / n_splits)``), skips the blocks no query row of its row
tile sees, computes its unnormalised ``(acc, m, l)``, and a combine folds the
splits in index order.  The emulation below follows that algorithm (the two
table walks, the row tiles, the visibility skip, the ``m_safe`` guard and the
ordered combine) and is held against ``kernels/paged.py::gather_verify_attn``
at the fp32 tolerance of the card's phase 2b, 1e-5 absolute plus relative.

It does not model the kernel's summation order inside a split (the 16-byte
chunks of a lane, the warp shuffles, the per-warp softmax states and their
merge): each split is computed here in one shot.  ``chip_smoke.py`` phase 2b
checks the kernels themselves on the card, K3 == K2 bit for bit.

Also here: the dense walk (every table entry, skipping -1) and the ragged
walk (``host_cu_blocks``) hand every split the same blocks, the wrapper's
``n_splits`` rule, and that both wrappers pass the kernel the same split
count and workspace whatever the tables hold; and the kernels' early exit
for a row tile of padding rows only (every position -1, no prefix: the
mixed verify+chunk launch pads each slot to the widest slot's columns),
which writes the partials the walk would have written.
"""
import inspect
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch, paged, tuning
from repro_torch.kernels import paged_verify_attn as K23
from test_torch_kernels import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 1e-5   # absolute plus relative: fp32 on both sides, sums in another order
INT_MAX = 2**31 - 1


def dense_walk(row, c, P):
    """K2's split list: every entry of the table row in order, keeping the
    live ones whose rank among live entries lies in [c*P, c*P + P)."""
    out, n = [], 0
    for e in row:
        if e >= 0:
            if c * P <= n < c * P + P:
                out.append(int(e))
            n += 1
    return out


def ragged_walk(row, steps, c, P):
    """K3's split list: ``steps`` = cu[b+1] - cu[b]; a split at or past the
    slot's steps reads no entry, and the walk (32 entries at a time, as one
    warp ballot) stops once the split's blocks are found."""
    lo = c * P
    want = min(lo + P, steps)
    found, n = {}, 0
    if lo < want:
        for j0 in range(0, len(row), 32):
            if n >= want:
                break
            for e in row[j0:j0 + 32]:
                if e >= 0:
                    if lo <= n < lo + P:
                        found[n - lo] = int(e)
                    n += 1
    return [found[i] for i in range(max(0, min(n, want) - lo))]


def visible(kp, qp, window, prefix_len):
    ok = (kp >= 0) & (kp <= qp)
    if window is not None:
        ok &= kp > qp - window
    if prefix_len:
        ok |= (kp >= 0) & (kp < prefix_len)
    return ok


def _tile_visible_block(kp, qlo, qhi, window, prefix_len):
    """The kernels' block skip: some key of the block passes the tile test."""
    ok = (kp >= 0) & (kp <= qhi)
    if window is not None:
        ok &= kp > qlo - window
    if prefix_len:
        ok |= (kp >= 0) & (kp < prefix_len)
    return bool(ok.any())


def emulate(q, k, v, q_pos, pos, bt, splits, window=None, prefix_len=0,
            k_scale=None, v_scale=None, walk="dense", early_exit=True, partials=None):
    """The kernels' algorithm in fp32: per (slot, kv-head, row tile, split)
    the split's live blocks, the visible ones, their (acc, m, l); then the
    splits folded in index order with the ``m_safe`` guard.  With
    ``early_exit`` a tile whose rows all sit at position -1 (and no prefix)
    takes the empty partial (0, -inf, 0) without a walk.  ``partials``
    (a dict) collects each tile's split partials by (b, kvh, tile)."""
    B, T, H, hd = q.shape
    bs, KVH = k.shape[1], k.shape[2]
    G, MAXB = H // KVH, bt.shape[1]
    P = -(-MAXB // splits)
    cu = tuning.host_cu_blocks(bt.numpy())
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale.float()[..., None], vf * v_scale.float()[..., None]
    out = torch.zeros(B, T, H, hd)
    for b in range(B):
        row = bt[b].tolist()
        for kvh in range(KVH):
            for tile in range(K23.row_tiles(G * T)):
                fr = range(tile * K23.ROW_TILE, min((tile + 1) * K23.ROW_TILE, G * T))
                heads = [kvh * G + f // T for f in fr]
                times = [f % T for f in fr]
                qr = q[b, times, heads].float()                       # [nr, hd]
                qp = q_pos[b, times]                                  # [nr]
                qhi = int(qp.max())
                qlo = int(qp[qp >= 0].min()) if (qp >= 0).any() else INT_MAX
                dead = early_exit and prefix_len == 0 and qhi < 0
                parts = []
                for c in range(splits):
                    if dead:
                        parts.append((torch.zeros(len(qr), hd),
                                      torch.full((len(qr),), -math.inf), torch.zeros(len(qr))))
                        continue
                    blocks = (dense_walk(row, c, P) if walk == "dense"
                              else ragged_walk(row, int(cu[b + 1] - cu[b]), c, P))
                    vis = [blk for blk in blocks
                           if _tile_visible_block(pos[blk], qlo, qhi, window, prefix_len)]
                    m = torch.full((len(qr),), -math.inf)
                    acc, l = torch.zeros(len(qr), hd), torch.zeros(len(qr))
                    if vis:
                        kp = pos[vis].reshape(-1)
                        kk = kf[vis, :, kvh].reshape(-1, hd)
                        vv = vf[vis, :, kvh].reshape(-1, hd)
                        s = (qr @ kk.T) * scale
                        ok = visible(kp[None], qp[:, None], window, prefix_len)
                        m = torch.where(ok, s, -math.inf).max(1).values
                        ms = torch.where(m == -math.inf, 0.0, m)
                        p = torch.where(ok, torch.exp(s - ms[:, None]), 0.0)
                        l, acc = p.sum(1), p @ vv
                    parts.append((acc, m, l))
                if partials is not None:
                    partials[(b, kvh, tile)] = parts
                M = torch.stack([m for _, m, _ in parts]).max(0).values
                Ms = torch.where(M == -math.inf, 0.0, M)
                A, L = torch.zeros(len(qr), hd), torch.zeros(len(qr))
                for acc, m, l in parts:                               # split order
                    f = torch.where(m == -math.inf, 0.0, torch.exp(m - Ms))
                    L, A = L + f * l, A + f[:, None] * acc
                out[b, times, heads] = A / L.clamp(min=1e-30)[:, None]
    return out


# (lens per slot, T, H, KVH, hd, bs, MAXB, holes, window, prefix_len, quant)
PATTERNS = {
    "holes": ([40, 23, 57], 3, 4, 2, 64, 8, 8, ((0, 1), (2, 3), (2, 4)), None, 0, False),
    "empty_slot": ([0, 30, 9, 61], 2, 4, 4, 64, 8, 8, (), None, 0, False),
    "all_empty": ([0, 0, 0], 2, 4, 2, 64, 8, 4, (), None, 0, False),
    "window": ([60, 45, 7], 2, 2, 2, 64, 8, 8, ((0, 2),), 10, 0, False),
    "prefix": ([60, 33], 3, 4, 2, 64, 8, 8, ((1, 1),), 6, 5, False),
    "int8": ([40, 0, 19], 3, 4, 2, 64, 8, 8, ((0, 2),), None, 0, True),
    "bs16_hd128": ([70, 12, 0, 33], 2, 8, 2, 128, 16, 5, ((0, 1),), None, 0, False),
    # the mixed launch's layout: slot 1 carries a 16-row chunk, slots 0 and
    # 2 their verify columns (REAL), the rest padding at position -1; with a
    # prefix the padding rows see the prefix keys, so no tile exits early
    "mixed": ([40, 23, 57], 16, 4, 2, 64, 8, 8, ((0, 1),), None, 0, False),
    "mixed_prefix": ([40, 23, 57], 16, 4, 2, 64, 8, 8, (), None, 5, False),
    # paligemma-3b's heads (8 over 1 kv-head of 256) after its bidirectional
    # prefix of 256 rows, 16 blocks of 16 that every row sees, with a hole
    "hd256_prefix256": ([300, 262], 4, 8, 1, 256, 16, 32, ((0, 20),), None, 256, False),
}
REAL = {"mixed": [1, 16, 4], "mixed_prefix": [1, 16, 4]}   # real query columns a slot


def _case(name, seed=0):
    """numpy inputs as the paged engine leaves them: slot b holds positions
    0 .. lens[b] + T - 2 in shuffled pool blocks, minus the holes; spare
    blocks hold garbage positions no table names; queries at the last T
    positions (1 .. T for an empty slot)."""
    lens, T, H, KVH, hd, bs, MAXB, holes, window, prefix_len, quant = PATTERNS[name]
    rng = np.random.default_rng(seed + len(name))
    B = len(lens)
    real = REAL.get(name, [T] * B)
    need = [-(-(n + t - 1) // bs) if n else 0 for n, t in zip(lens, real)]
    NB = sum(need) + 3
    order, nxt = rng.permutation(NB), 0
    bt = np.full((B, MAXB), -1, np.int32)
    pos = rng.integers(0, 200, (NB, bs)).astype(np.int32)
    for b, (n, t_real) in enumerate(zip(lens, real)):
        for j in range(need[b]):
            if (b, j) in holes:
                continue
            pb = int(order[nxt])
            nxt += 1
            bt[b, j] = pb
            rows = j * bs + np.arange(bs)
            pos[pb] = np.where(rows < n + t_real - 1, rows, -1)
    q_pos = np.stack([np.where(np.arange(T) < t, np.arange(T) + (n - 1 if n else 1), -1)
                      for n, t in zip(lens, real)]).astype(np.int32)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((NB, bs, KVH, hd)).astype(np.float32)
    ks = vs = None
    if quant:
        ks = (np.abs(k).max(-1) / 127.0 + 1e-8).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0 + 1e-8).astype(np.float32)
        k = np.clip(np.round(k / ks[..., None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[..., None]), -127, 127).astype(np.int8)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return dict(q=t(q), k=t(k), v=t(v), q_pos=t(q_pos), pos=t(pos), bt=t(bt),
                k_scale=t(ks), v_scale=t(vs), window=window, prefix_len=prefix_len)


@pytest.mark.parametrize("splits", [1, 2, 3, "maxb"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_split_emulation_matches_gather(pattern, splits):
    """Per-split (acc, m, l) over the visible live blocks, folded in split
    order, equals the gather path; no NaN; empty slots give exact zeros.
    ``maxb`` gives one block per split: more splits than live blocks."""
    c = _case(pattern)
    n = c["bt"].shape[1] if splits == "maxb" else splits
    kw = dict(window=c["window"], prefix_len=c["prefix_len"], k_scale=c["k_scale"],
              v_scale=c["v_scale"])
    args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"])
    want = paged.gather_verify_attn(*args, **kw)
    for walk in ("dense", "ragged"):
        got = emulate(*args, n, walk=walk, **kw)
        assert not torch.isnan(got).any()
        err = (got - want).abs()
        assert bool((err <= TOL + TOL * want.abs()).all()), float(err.max())
        empty = (c["bt"] < 0).all(1)
        assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("pattern", ["mixed", "mixed_prefix"])
def test_padding_tiles_exit_with_the_walks_partials(pattern, splits):
    """A row tile of padding rows only writes, without its walk, the
    partials (and so the output rows) its walk would write: bit for bit;
    the mixed layout has such tiles, and with a prefix none exits."""
    c = _case(pattern)
    args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"], splits)
    kw = dict(window=c["window"], prefix_len=c["prefix_len"])
    walked, exited = {}, {}
    a = emulate(*args, early_exit=False, partials=walked, **kw)
    b = emulate(*args, partials=exited, **kw)
    assert torch.equal(a, b)
    G, T = c["q"].shape[2] // c["k"].shape[2], c["q"].shape[1]
    dead = [key for key in walked
            if bool((c["q_pos"][key[0], [f % T for f in range(key[2] * K23.ROW_TILE,
                     min((key[2] + 1) * K23.ROW_TILE, G * T))]] < 0).all())]
    assert dead, "the pattern has no padding-only tile"
    for key in walked:
        for (acc0, m0, l0), (acc1, m1, l1) in zip(walked[key], exited[key]):
            assert torch.equal(acc0, acc1) and torch.equal(m0, m1) and torch.equal(l0, l1)
    if c["prefix_len"]:   # padding rows see the prefix keys: not zero
        assert bool((a[c["q_pos"] < 0].abs().sum(-1) > 0).all())
    else:
        assert bool((a[c["q_pos"] < 0] == 0).all())


def test_window_leaves_whole_splits_invisible():
    """The premise of the window pattern: with one block per split, some
    splits of a long slot hold live blocks that no query row sees, so the
    kernel skips all of their K/V."""
    c = _case("window")
    bt, pos = c["bt"].numpy(), c["pos"]
    qp = c["q_pos"][0]
    qlo, qhi = int(qp.min()), int(qp.max())
    blocks = [dense_walk(bt[0].tolist(), s, 1) for s in range(bt.shape[1])]
    skipped = [s for s, blk in enumerate(blocks)
               if blk and not _tile_visible_block(pos[blk[0]], qlo, qhi, c["window"], 0)]
    assert len(skipped) >= 2


@pytest.mark.parametrize("seed", range(4))
def test_dense_and_ragged_walks_hand_each_split_the_same_blocks(seed):
    """What K3 == K2 bit for bit rests on: a hole must not move keys from
    one split to the next in K2 and not in K3.  Both walks give every split the
    same ordered blocks, and the splits together are the live list."""
    rng = np.random.default_rng(seed)
    B, MAXB = 6, int(rng.integers(1, 70))
    tables = np.where(rng.random((B, MAXB)) < 0.35, -1,
                      rng.integers(0, 500, (B, MAXB))).astype(np.int32)
    tables[0] = -1                                           # an empty slot
    tables[1, :] = np.arange(MAXB)                           # a full slot
    cu = tuning.host_cu_blocks(tables)
    for b in range(B):
        row = tables[b].tolist()
        live = [e for e in row if e >= 0]
        for splits in range(1, MAXB + 2):
            P = -(-MAXB // splits)
            dense = [dense_walk(row, c, P) for c in range(splits)]
            ragged = [ragged_walk(row, int(cu[b + 1] - cu[b]), c, P) for c in range(splits)]
            assert dense == ragged
            assert [e for d in dense for e in d] == live


def test_n_splits_depends_on_shapes_and_sm_count_only():
    assert list(inspect.signature(K23.n_splits).parameters) == [
        "B", "KVH", "rows", "MAXB", "bs", "sms", "hd"]
    for B, KVH, rows, MAXB, bs, sms, hd in itertools.product(
            (1, 2, 4, 8, 16, 64), (1, 4, 8, 32), (1, 4, 7, 9, 28, 40), (1, 3, 32, 64, 256),
            (1, 8, 16, 64), (66, 132), (64, 128, 256)):
        n = K23.n_splits(B, KVH, rows, MAXB, bs, sms, hd)
        assert 1 <= n <= MAXB
        blocks = B * KVH * K23.row_tiles(rows)
        if blocks >= 2 * sms:
            assert n == 1
        else:   # two waves, unless a split would get under a stage (or past hd 256's cap)
            cap = max(1, min(MAXB, MAXB * bs // K23.STAGE_KEYS))
            if hd == 256:
                cap = min(cap, K23.MAX_SPLITS_HD256)
            assert n * blocks >= 2 * sms or n == cap


@pytest.mark.parametrize("shape,want", [
    ((16, 32, 1, 32, 16, 128), 1),  # the paged main path: 512 blocks fill the card
    ((1, 32, 1, 32, 16, 128), 9),   # one slot: only the splits fill it
    ((8, 4, 32, 32, 16, 128), 3),   # yi-9b GQA, T 4: 4 row tiles of 8
    ((16, 1, 32, 32, 16, 256), 4),  # paligemma-3b's paged verify at s 3 (phase 12b)
    ((16, 1, 8, 32, 16, 256), 4),   # ... at s 0
])
def test_n_splits_at_phase_2b_shapes(shape, want):
    assert K23.n_splits(*shape[:5], 132, shape[5]) == want


def test_both_wrappers_give_the_kernel_the_same_split_count(monkeypatch):
    """K2 and K3 hand the C entry point the same n_splits and workspace for
    the same shapes, whatever the tables hold, and a call counts once
    although it issues two device kernels.  The device is stood in for:
    the entry point is a recorder."""
    calls = []

    def fake_invoke(entry, dev, *args):
        calls.append(args)
        return 0
    monkeypatch.setattr(K23, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K23, "sm_count", lambda dev: 132)
    monkeypatch.setattr(K23, "invoke", fake_invoke)
    # the stand-in calls count; give the counts back afterwards, since
    # test_torch_paged_attn.py holds that nothing launched in its worker
    monkeypatch.setattr(K23.DENSE, "launches", K23.DENSE.launches)
    monkeypatch.setattr(K23.RAGGED, "launches", K23.RAGGED.launches)
    c = _case("holes")
    args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"])
    tables = [c["bt"], torch.flip(c["bt"], (1,)).contiguous(),
              torch.full_like(c["bt"], -1)]
    before = (K23.DENSE.launches, K23.RAGGED.launches)
    for bt in tables:
        cu = torch.from_numpy(tuning.host_cu_blocks(bt.numpy()))
        K23.paged_verify_attn_cuda(*args, bt)
        K23.ragged_paged_verify_attn_cuda(*args, bt, cu)
    assert (K23.DENSE.launches, K23.RAGGED.launches) == (before[0] + 3, before[1] + 3)
    B, T, H, hd = c["q"].shape
    KVH, MAXB = c["k"].shape[2], c["bt"].shape[1]
    want = K23.n_splits(B, KVH, (H // KVH) * T, MAXB, c["k"].shape[1], 132, hd)
    assert want > 1
    # (ragged, ..., B, T, H, KVH, bs, MAXB, hd, n_splits, ws): the geometry
    geometry = {tuple(a[13:21]) + (a[21] is not None,) for a in calls}
    assert geometry == {(B, T, H, KVH, c["k"].shape[1], MAXB, hd, want, True)}
    assert [a[0] for a in calls] == [0, 1] * 3
    assert launch.device_kernels(want) == 2 and launch.device_kernels(1) == 1
    assert K23.workspace_floats(B, KVH, (H // KVH) * T, hd, want) == (
        B * KVH * want * K23.row_tiles((H // KVH) * T) * K23.ROW_TILE * (hd + 2))


def test_wrapper_refuses_a_block_beyond_shared_memory(monkeypatch):
    """At hd 256 an fp32 block of 64-row pool blocks would need 397 KB of
    shared memory: the source measures its geometry against the card's
    opt-in limit and refuses it with cudaErrorInvalidConfiguration, which
    the wrapper raises as a ValueError without counting a launch.  The
    card is stood in for: the entry point refuses the one shape the
    source refuses (``chip_smoke.py``'s phase 1 checks it on the card)."""
    calls = []
    monkeypatch.setattr(K23, "on_one_cuda_device", lambda tensors, dev: True)
    monkeypatch.setattr(K23, "sm_count", lambda dev: 132)

    def entry(entry, dev, *args):     # (ragged, q_dtype, kv_dtype, ..., bs at 17, hd at 19)
        calls.append(args)
        return 9 if (args[1], args[17], args[19]) == (0, 64, 256) else 0
    monkeypatch.setattr(K23, "invoke", entry)
    monkeypatch.setattr(K23.RAGGED, "launches", K23.RAGGED.launches)
    B, T, H, hd = 2, 4, 8, 256
    for dtype, bs, fits in ((torch.float32, 64, False), (torch.bfloat16, 64, True),
                            (torch.float32, 16, True)):
        q = torch.zeros((B, T, H, hd), dtype=dtype)
        k = torch.zeros((6, bs, 1, hd), dtype=dtype)
        qp = torch.zeros((B, T), dtype=torch.int32)
        pos = torch.zeros((6, bs), dtype=torch.int32)
        bt = torch.zeros((B, 4), dtype=torch.int32)
        cu = torch.from_numpy(tuning.host_cu_blocks(bt.numpy()))
        n, launches = len(calls), K23.RAGGED.launches
        if fits:
            K23.ragged_paged_verify_attn_cuda(q, k, k, qp, pos, bt, cu)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                K23.ragged_paged_verify_attn_cuda(q, k, k, qp, pos, bt, cu)
        assert len(calls) == n + 1
        assert K23.RAGGED.launches == launches + fits
