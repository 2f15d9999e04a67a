#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, one report line each (the last line is the JSON verdict):

1. device   the card's name and power limit; TF32 off for the fp32 phases;
            the CUDA kernels built from ``src/repro_torch/kernels/csrc``.
2. kernels  the verify-attention kernel K1 held against its plain PyTorch
            version at the shapes the serving paths give it (target and
            draft prefill, verify at s = 0, 3, 8, draft decode; phase 6b's
            B = 1 prefills of a padded prompt into a 512-row ring and its
            B = 16 draft decode) plus GQA,
            window, prefix, fully masked rows, int8 + scales and ragged
            cache lengths, in fp32 and bf16, with its time beside the plain
            version's, a library call's and the card's bound.
2b. paged   the paged kernels K2 (dense) and K3 (ragged) held against the
            plain gather path at the full-width OPT-6.7B verify (B 16,
            T 1, 4, 7, ragged tables with holes and an empty slot, and a
            full pool of 192 blocks), GQA at yi-9b widths, window,
            prefix, int8 + scales, block size 8 and all slots empty, in
            fp32 and bf16; K3 must equal K2 bit for bit.
3. parity   full-width target and draft cut to 2 layers, fp32: prefill + 8
            greedy steps on the card (kernel) against the same on the CPU
            (plain version), and speculative generate(s) == generate(0).
4. serve    the paper's profile -> LUT -> adaptive serving loop
            (``repro_torch.launch.serve``) on the full-width OPT-6.7B +
            OPT-125M pair in bf16, with the kernel's launch count read
            around it.
5. profile  one serving step of that pair at B = 8, s = 0 and 3, and one
            paged step at B = 16: wall time against the device time
            ``torch.profiler`` sees.
6a. continuous parity  the live continuous-batching runtime
            (``serve_continuous_live``) on the full-width pair cut to 2
            layers, fp32, with an undersized paged pool: tokens of the
            paged run, the contiguous run and each request's solo
            ``generate`` identical, preemptions seen, the paged StepTrace
            equal to its ``SimStepBackend`` replay, and the model's paged
            ``decode_step`` giving the same logits through K2 and K3.
6b. continuous serve  ``serve_continuous_live`` on the full-width pair in
            bf16 with phase 4's LUT: 16 slots, a paged pool of 144 blocks
            that runs short as requests grow, so running requests are
            preempted and re-prefilled; 32 requests; the ragged kernel's
            launches read around it.

Exits non-zero, printing no verdict, without CUDA or when any phase fails.
Everything it prints also goes to ``chiprun_out/chip_smoke.log`` beside it,
since a remote run may return only the tail of standard output.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"float32": 67e12,        # fp32 outside the tensor cores
            "bfloat16": 989e12}      # dense bf16 tensor cores
TOL = {"float32": 1e-5,   # same inputs, fp32 math; only the summation order differs
       "bfloat16": 1e-2}  # bf16 output rounding (2^-9 relative) against an fp32 plain run


class PhaseFailed(RuntimeError):
    pass


class Tee:
    """Write to several streams (standard output and the report file)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version


def make_case(torch, name, *, B, T, H, KVH, hd, L, dtype, n_ctx, window=None,
              prefix_len=0, quant=False, masked_row=False, kv_len=None, seed=0):
    """Inputs shaped as the serving path gives them: a ring cache of length
    L whose rows hold positions up to n_ctx + T - 2 (older rows overwritten
    when it wraps, unwritten rows -1), queried by T rows ending there.
    ``kv_len`` makes a prefill of a right-padded prompt: only positions
    below it are written, the padded rows stay -1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)

    dt = getattr(torch, dtype)
    q = rnd(B, T, H, hd).to(dt)
    if quant:
        k = torch.randint(-127, 128, (B, L, KVH, hd), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        v = torch.randint(-127, 128, (B, L, KVH, hd), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        ks = (rnd(B, L, KVH).abs() / 127 + 1e-3).to(dt)
        vs = (rnd(B, L, KVH).abs() / 127 + 1e-3).to(dt)
    else:
        k, v, ks, vs = rnd(B, L, KVH, hd).to(dt), rnd(B, L, KVH, hd).to(dt), None, None
    # per request: context length n (ragged over the batch), queries at
    # n-1 .. n+T-2, cache rows hold the newest L positions below n+T-1
    n = torch.tensor([max(1, n_ctx - 3 * b) for b in range(B)], device=dev,
                     dtype=torch.int32)
    q_pos = (n[:, None] - 1 + torch.arange(T, device=dev, dtype=torch.int32)).contiguous()
    top = (n + T - 1)[:, None]                                   # exclusive
    rows = torch.arange(L, device=dev, dtype=torch.int32)[None]
    cand = rows + ((top - 1 - rows).clamp(min=0) // L) * L       # newest position at row
    k_pos = torch.where(cand < top, cand, -1).to(torch.int32)
    if kv_len is not None:
        k_pos = torch.where(k_pos < kv_len, k_pos, -1)
    k_pos = k_pos.contiguous()
    if masked_row:
        q_pos[0, :] = -1
    return dict(name=name, q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos, window=window,
                prefix_len=prefix_len, k_scale=ks, v_scale=vs, dtype=dtype,
                shape=f"B{B} T{T} H{H}/{KVH}x{hd} L{L}"
                      + (f" kv_len {kv_len}" if kv_len is not None else ""))


def visible(torch, c):
    qp, kp = c["q_pos"][:, :, None], c["k_pos"][:, None, :]
    ok = (kp >= 0) & (kp <= qp)
    if c["window"] is not None:
        ok &= kp > qp - c["window"]
    if c["prefix_len"]:
        ok |= (kp >= 0) & (kp < c["prefix_len"])
    return ok                                                    # [B, T, L]


def bound(torch, c):
    """Least time for the call: bytes it must move (each input read once,
    K/V rows only where some query sees them, the output written once)
    against operations on the visible pairs, at the card's peaks."""
    q, k = c["q"], c["k"]
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    ok = visible(torch, c)
    rows = int(ok.any(1).sum())                  # visible key rows, summed over b
    pairs = int(ok.sum())                        # visible (query, key) pairs
    kv = 2 * rows * KVH * hd * k.element_size()
    if c["k_scale"] is not None:
        kv += 2 * rows * KVH * c["k_scale"].element_size()
    nbytes = kv + 2 * q.numel() * q.element_size() + 4 * (c["q_pos"].numel()
                                                          + c["k_pos"].numel())
    ops = 4 * pairs * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[c["dtype"]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_ms(torch, fn, arg_sets, iters=20):
    """Device time per call: the calls are queued behind a sleeping kernel,
    so they run back to back whatever the host's own cost per call."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    e0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def run_kernel_case(torch, K1, ref, c):
    kw = dict(window=c["window"], prefix_len=c["prefix_len"])
    quant = c["k_scale"] is not None

    def kernel(q, k, v, qp, kp, ks, vs):
        return K1.spec_verify_attn_cuda(q, k, v, qp, kp, k_scale=ks, v_scale=vs, **kw)

    def plain(q, k, v, qp, kp, ks, vs):
        if ks is not None:                       # ops.py's plain int8 path
            k = (k.float() * ks.float()[..., None]).to(q.dtype)
            v = (v.float() * vs.float()[..., None]).to(q.dtype)
        return ref.gqa_masked_ref(q, k, v, qp, kp, **kw)

    args = (c["q"], c["k"], c["v"], c["q_pos"], c["k_pos"], c["k_scale"], c["v_scale"])
    got = kernel(*args)
    torch.cuda.synchronize()
    f32 = tuple(None if x is None else (x.float() if x.is_floating_point() else x)
                for x in args)
    if quant:   # dequantize in fp32 (the kernel's order), then the fp32 plain run
        f32 = (f32[0], c["k"].float() * f32[5][..., None],
               c["v"].float() * f32[6][..., None], f32[3], f32[4], None, None)
    want = plain(*f32)
    err = (got.float() - want).abs()
    tol = TOL[c["dtype"]]
    max_err = float(err.max())
    ok = bool((err <= tol + tol * want.abs()).all())
    if c["q_pos"].min() < 0 and not c["prefix_len"]:
        ok &= bool((got[c["q_pos"] < 0] == 0).all())          # fully masked rows are 0
    # rotate over copies of the inputs so that repeated calls do not find
    # them in the 50 MB L2 cache, as the serving step does not
    case_bytes = sum(x.numel() * x.element_size() for x in args if x is not None)
    copies = min(64, max(2, math.ceil(2 * 50e6 / case_bytes)))
    sets = [tuple(None if x is None else x.clone() for x in args) for _ in range(copies)]
    kernel_ms = device_ms(torch, kernel, sets)
    plain_ms = device_ms(torch, plain, sets)
    library_ms = None
    if not quant:
        import torch.nn.functional as F
        G = c["q"].shape[2] // c["k"].shape[2]
        lib_sets = [(s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
                     visible(torch, dict(c, q_pos=s[3], k_pos=s[4]))[:, None])
                    for s in sets]

        def library(q, k, v, mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=G > 1)
        library_ms = device_ms(torch, library, lib_sets)
    bound_ms, bound_by = bound(torch, c)
    del sets
    return dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=max_err,
                tol=tol, ok=ok, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(torch, K1, ref):
    T_H, T_KVH, T_HD = 32, 32, 128            # opt-6.7b attention
    D_H, D_KVH, D_HD = 12, 12, 64             # opt-125m attention
    L = 256                                   # the launcher's --cache-len
    specs = [
        ("target_prefill_b1", dict(B=1, T=16, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=1)),
        ("target_prefill_b8", dict(B=8, T=32, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=1)),
        ("target_verify_s0_b8", dict(B=8, T=1, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=40)),
        ("target_verify_s3_b8", dict(B=8, T=4, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=40)),
        ("target_verify_s8_b8", dict(B=8, T=9, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=40)),
        ("draft_prefill_b8", dict(B=8, T=32, H=D_H, KVH=D_KVH, hd=D_HD, L=L, n_ctx=1)),
        ("draft_decode_t2_b8", dict(B=8, T=2, H=D_H, KVH=D_KVH, hd=D_HD, L=L, n_ctx=40)),
        ("draft_decode_t1_b8", dict(B=8, T=1, H=D_H, KVH=D_KVH, hd=D_HD, L=L, n_ctx=41)),
        ("gqa_g4", dict(B=4, T=9, H=32, KVH=8, hd=128, L=L, n_ctx=100)),
        ("window_64_wrapped", dict(B=4, T=4, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=300,
                                   window=64)),
        ("prefix_16", dict(B=4, T=4, H=D_H, KVH=D_KVH, hd=D_HD, L=L, n_ctx=100,
                           prefix_len=16)),
        ("masked_rows", dict(B=2, T=4, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=50,
                             masked_row=True)),
        ("int8_scales", dict(B=8, T=4, H=T_H, KVH=T_KVH, hd=T_HD, L=L, n_ctx=200,
                             quant=True)),
        ("ragged_L200", dict(B=4, T=37, H=32, KVH=8, hd=64, L=200, n_ctx=150)),
        ("ragged_L40", dict(B=3, T=5, H=D_H, KVH=D_KVH, hd=D_HD, L=40, n_ctx=30)),
    ]
    # phase 6b (continuous, paged): prefill_into's B = 1 prefill of a prompt
    # padded to its bucket (64, 128, 256) into a ring of the pool's logical
    # length 512, the target fed plen - 1 tokens and the draft plen - 2;
    # and the draft's decode over the 16 slots when the LUT picks s > 0
    for P, plen in ((64, 59), (128, 101), (256, 213)):
        specs += [
            (f"cont_target_prefill_t{P}", dict(B=1, T=P, H=T_H, KVH=T_KVH, hd=T_HD, L=512,
                                               n_ctx=1, kv_len=plen - 1)),
            (f"cont_draft_prefill_t{P}", dict(B=1, T=P, H=D_H, KVH=D_KVH, hd=D_HD, L=512,
                                              n_ctx=1, kv_len=plen - 2))]
    specs += [
        ("cont_draft_decode_t2_b16", dict(B=16, T=2, H=D_H, KVH=D_KVH, hd=D_HD, L=512,
                                          n_ctx=200)),
        ("cont_draft_decode_t1_b16", dict(B=16, T=1, H=D_H, KVH=D_KVH, hd=D_HD, L=512,
                                          n_ctx=201)),
    ]
    rows = []
    for i, (name, kw) in enumerate(specs):
        for dtype in ("float32", "bfloat16"):
            c = make_case(torch, f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                          dtype=dtype, seed=i, **kw)
            r = run_kernel_case(torch, K1, ref, c)
            rows.append(r)
            print("  " + json.dumps(r), flush=True)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 2b: the paged kernels K2 and K3 against the plain gather path


def make_paged_case(torch, np, name, *, B, T, H, KVH, hd, bs, MAXB, ctx, dtype,
                    holes=(), window=None, prefix_len=0, quant=False, seed=0):
    """A pool as the paged engine leaves it before the verify attention:
    slot b's rows hold positions 0 .. ctx[b] + T - 2 (its context and this
    step's T query rows) in blocks taken from a shuffled pool, with the
    (slot, logical block) entries in ``holes`` set to -1 and left unowned.
    ctx[b] = 0 is an empty slot: table row all -1, queries at 1 .. T as the
    engine gives them.  Spare blocks and the trash block hold garbage rows
    and positions that no table names."""
    from repro_torch.kernels.tuning import host_cu_blocks
    rng = np.random.default_rng(seed)
    need = [-(-(n + T - 1) // bs) if n else 0 for n in ctx]
    NB = sum(need) + 8 + 1
    order = rng.permutation(NB - 1)
    bt = np.full((B, MAXB), -1, np.int32)
    pos = rng.integers(0, 4096, (NB, bs)).astype(np.int32)      # garbage
    nxt = 0
    for b, n in enumerate(ctx):
        for j in range(need[b]):
            if (b, j) in holes:
                continue
            pb = int(order[nxt])
            nxt += 1
            bt[b, j] = pb
            rows = np.arange(j * bs, (j + 1) * bs)
            pos[pb] = np.where(rows < n + T - 1, rows, -1)
    q_pos = np.stack([np.arange(T) + (n - 1 if n else 1) for n in ctx]).astype(np.int32)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)

    q = rnd(B, T, H, hd).to(dt)
    if quant:
        k, v = (torch.randint(-127, 128, (NB, bs, KVH, hd), generator=g, device="cuda",
                              dtype=torch.int32).to(torch.int8) for _ in range(2))
        ks = (rnd(NB, bs, KVH).abs() / 127 + 1e-3).to(dt)
        vs = (rnd(NB, bs, KVH).abs() / 127 + 1e-3).to(dt)
    else:
        k, v, ks, vs = rnd(NB, bs, KVH, hd).to(dt), rnd(NB, bs, KVH, hd).to(dt), None, None
    cuda = lambda a: torch.from_numpy(a).cuda()
    return dict(name=name, q=q, k=k, v=v, q_pos=cuda(q_pos), pos=cuda(pos), bt=cuda(bt),
                cu=cuda(host_cu_blocks(bt)), window=window, prefix_len=prefix_len,
                k_scale=ks, v_scale=vs, dtype=dtype, tables=bt,
                shape=f"B{B} T{T} H{H}/{KVH}x{hd} bs{bs} MAXB{MAXB} "
                      f"live blocks {int((bt >= 0).sum())}")


def paged_bound(torch, paged, c):
    """Least time for one paged verify call: q, out, q_pos, the table (and
    cu_blocks), the positions of every owned block, and the K/V (and
    scales) of the owned blocks some query sees, against the operations on
    the visible (query, key) pairs."""
    q, k = c["q"], c["k"]
    B, T, H, hd = q.shape
    bs, KVH = k.shape[1], k.shape[2]
    kp = paged.gather_key_positions(c["pos"], c["bt"])             # [B, MAXB*bs]
    ok = visible(torch, dict(c, k_pos=kp))                          # [B, T, MAXB*bs]
    owned = int((c["bt"] >= 0).sum())
    vis_blocks = int(ok.any(1).reshape(B, -1, bs).any(-1).sum())
    per_row = 2 * KVH * hd * k.element_size()
    if c["k_scale"] is not None:
        per_row += 2 * KVH * c["k_scale"].element_size()
    nbytes = (vis_blocks * bs * per_row + 2 * q.numel() * q.element_size()
              + 4 * (c["q_pos"].numel() + c["bt"].numel() + c["cu"].numel()
                     + owned * bs))
    ops = 4 * int(ok.sum()) * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[c["dtype"]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_paged_case(torch, K23, paged, ref, c):
    import torch.nn.functional as F
    kw = dict(window=c["window"], prefix_len=c["prefix_len"])
    quant = c["k_scale"] is not None

    def dense(q, k, v, qp, pos, bt, cu, ks, vs):
        return K23.paged_verify_attn_cuda(q, k, v, qp, pos, bt, k_scale=ks, v_scale=vs, **kw)

    def ragged(q, k, v, qp, pos, bt, cu, ks, vs):
        return K23.ragged_paged_verify_attn_cuda(q, k, v, qp, pos, bt, cu, k_scale=ks,
                                                 v_scale=vs, **kw)

    def plain(q, k, v, qp, pos, bt, cu, ks, vs):
        return paged.gather_verify_attn(q, k, v, qp, pos, bt, k_scale=ks, v_scale=vs, **kw)

    def library(q, k, v, qp, pos, bt, cu, ks, vs):
        # two calls: the gather, then SDPA with the position mask
        kg, vg = paged.gather_kv_blocks(k, v, bt)
        mask = visible(torch, dict(c, q_pos=qp, k_pos=paged.gather_key_positions(pos, bt)))
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=q.shape[2] != k.shape[2])

    args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"], c["cu"], c["k_scale"],
            c["v_scale"])
    got2 = dense(*args)
    got3 = ragged(*args)
    torch.cuda.synchronize()
    f32 = tuple(None if x is None else (x.float() if x.is_floating_point() else x)
                for x in args)
    if quant:   # dequantize in fp32 (the kernels' order), then the fp32 plain run
        f32 = (f32[0], c["k"].float() * f32[7][..., None],
               c["v"].float() * f32[8][..., None], *f32[3:7], None, None)
    want = plain(*f32)
    err = (got3.float() - want).abs()
    tol = TOL[c["dtype"]]
    max_err = float(err.max())
    ok = bool((err <= tol + tol * want.abs()).all())
    same = bool(torch.equal(got2, got3))
    empty = torch.from_numpy((c["tables"] < 0).all(1)).cuda()
    zero_rows = bool((got3[empty] == 0).all())
    case_bytes = sum(x.numel() * x.element_size() for x in args if x is not None)
    copies = min(64, max(2, math.ceil(2 * 50e6 / case_bytes)))
    sets = [tuple(None if x is None else x.clone() for x in args) for _ in range(copies)]
    dense_ms = device_ms(torch, dense, sets)
    ragged_ms = device_ms(torch, ragged, sets)
    plain_ms = device_ms(torch, plain, sets)
    library_ms = None if quant else device_ms(torch, library, sets)
    bound_ms, bound_by = paged_bound(torch, paged, c)
    del sets
    return dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=max_err,
                tol=tol, ok=ok and same and zero_rows, k3_equals_k2=same,
                empty_rows_zero=zero_rows, ms=ragged_ms, dense_ms=dense_ms,
                plain_ms=plain_ms, library_ms=library_ms, library="gather + SDPA (two calls)",
                bound_ms=bound_ms, bound_by=bound_by)


def phase_paged_kernels(torch, np, K23, paged, ref):
    rng = np.random.default_rng(17)
    opt = dict(H=32, KVH=32, hd=128, bs=16, MAXB=32)      # opt-6.7b verify, cache_len 512

    def ragged_ctx(B, T):
        return [0] + [int(x) for x in rng.integers(16, 512 - T, size=B - 1)]

    specs = [
        (f"opt_verify_t{T}", dict(B=16, T=T, ctx=ragged_ctx(16, T), holes=((1, 2), (5, 0)),
                                  **opt))
        for T in (1, 4, 7)]
    specs += [
        # a full pool at phase 6b's widths: 16 slots x 12 blocks of 16
        ("opt_pool_full_t1", dict(B=16, T=1, ctx=[192] * 16, **opt)),
        ("gqa_yi9b_t4", dict(B=8, T=4, H=32, KVH=4, hd=128, bs=16, MAXB=32,
                             ctx=ragged_ctx(8, 4), holes=((2, 1),))),
        ("window_64", dict(B=8, T=4, ctx=ragged_ctx(8, 4), window=64, **opt)),
        ("prefix_16", dict(B=8, T=4, H=12, KVH=12, hd=64, bs=16, MAXB=32,
                           ctx=ragged_ctx(8, 4), prefix_len=16)),
        ("int8_scales", dict(B=8, T=4, ctx=ragged_ctx(8, 4), holes=((3, 1),), quant=True,
                             **opt)),
        ("block_size_8", dict(B=8, T=4, H=12, KVH=12, hd=64, bs=8, MAXB=64,
                              ctx=ragged_ctx(8, 4))),
        ("all_empty", dict(B=4, T=4, ctx=[0, 0, 0, 0], **opt)),
    ]
    rows = []
    for i, (name, kw) in enumerate(specs):
        for dtype in ("float32", "bfloat16"):
            c = make_paged_case(torch, np, f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                                dtype=dtype, seed=100 + i, **kw)
            r = run_paged_case(torch, K23, paged, ref, c)
            rows.append(r)
            print("  " + json.dumps(r), flush=True)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"paged kernels disagree with the plain path or K3 != K2: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: full width, 2 layers, fp32: card against CPU


def greedy_logits(torch, model, params, tokens, lens, steps, cache_len, device):
    """Prefill, then ``steps`` one-token decode steps feeding the argmax."""
    cache = model.init_cache(tokens.shape[0], cache_len, torch.float32, device)
    toks = tokens.to(device)
    logits, cache, seq = model.prefill(params, toks, cache, lens.to(device))
    out_l, out_t = [logits.cpu()], []
    nxt = torch.argmax(logits, -1)
    seq = seq + 1
    for _ in range(steps):
        out_t.append(nxt.cpu())
        logits, cache = model.decode_step(params, nxt[:, None].to(torch.int32), cache,
                                          seq)
        out_l.append(logits[:, 0].cpu())
        nxt = torch.argmax(logits[:, 0], -1)
        seq = seq + 1
    return torch.stack(out_l, 1), (torch.stack(out_t, 1) if out_t else None)


def top2_margin(torch, logits):
    top = torch.topk(logits, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


def phase_parity(torch, np, R, DecoderLM, SpecDecodeEngine, tree_to):
    tcfg = R.get_config("opt-6.7b").with_(n_layers=2)
    dcfg = R.get_draft_config("opt-6.7b").with_(n_layers=2)
    tgt = DecoderLM(tcfg)
    gen = torch.Generator().manual_seed(7)
    tp_cpu = tgt.init(gen, torch.float32, "cpu")
    dp_cpu = DecoderLM(dcfg).init(gen, torch.float32, "cpu")
    tp_gpu, dp_gpu = tree_to(tp_cpu, "cuda"), tree_to(dp_cpu, "cuda")
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int64))
    lens = torch.tensor([16, 11], dtype=torch.int32)
    lg_gpu, tk_gpu = greedy_logits(torch, tgt, tp_gpu, tokens, lens, 8, 64, "cuda")
    lg_cpu, tk_cpu = greedy_logits(torch, tgt, tp_cpu, tokens, lens, 8, 64, "cpu")
    tol = 2e-3   # fp32 on both sides; 4096- and 16384-long dot products summed in another order
    err = (lg_gpu - lg_cpu).abs()
    ok_logits = bool((err <= tol + tol * lg_cpu.abs()).all())
    same = bool((tk_gpu == tk_cpu).all())
    line = dict(logits_max_abs_err=float(err.max()), tol=tol, greedy_tokens_equal=same,
                min_top2_margin=top2_margin(torch, lg_cpu))
    eng = SpecDecodeEngine(tcfg, dcfg, max_new=12, dtype=torch.float32, device="cuda")
    toks_np, lens_np = tokens.numpy().astype(np.int32), lens.numpy()
    ref, _, _ = eng.generate(tp_gpu, dp_gpu, toks_np, lens_np, s=0, cache_len=64)
    spec_equal = {}
    for s in (1, 2, 4):
        out, stats, _ = eng.generate(tp_gpu, dp_gpu, toks_np, lens_np, s=s, cache_len=64,
                                     collect_stats=True)
        spec_equal[s] = bool((out == ref).all())
        if not spec_equal[s]:
            b, t = map(int, np.argwhere(out != ref)[0])
            # margin of the target's own greedy choice where the streams part
            pref = np.concatenate([toks_np[b, :lens_np[b]], ref[b, :t]])
            lg, _ = greedy_logits(torch, tgt, tp_gpu, torch.from_numpy(pref[None].astype(
                np.int64)), torch.tensor([len(pref)], dtype=torch.int32), 0, 64, "cuda")
            line[f"s{s}_first_divergence"] = dict(row=b, token=t,
                                                  top2_margin=top2_margin(torch, lg))
    line["spec_equals_greedy"] = spec_equal
    print("  " + json.dumps(line), flush=True)
    check(ok_logits, f"card vs CPU logits differ by {float(err.max())} > {tol}")
    check(same, "card vs CPU greedy tokens differ")
    check(all(spec_equal.values()), f"speculative tokens differ from greedy: {spec_equal}")
    return line


# ---------------------------------------------------------------------------
# phase 5: where one serving step's time goes


def phase_profile(torch, np, R, SpecDecodeEngine):
    """Full-width pair, bf16: the wall time of one engine step at B = 8,
    s = 0 and s = 3 on the ring cache, and at B = 16, s = 0 on a paged pool
    of 16 x 8 blocks, against the device time that ``torch.profiler`` sees,
    with the verify kernels' share and the host's most expensive ops."""
    from torch.profiler import ProfilerActivity, profile
    bf16 = torch.bfloat16
    eng = SpecDecodeEngine(R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b"),
                           max_new=64, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, eng.tcfg.vocab_size, (8, 16)).astype(np.int32)
    lens = np.full((8,), 16, np.int32)
    steps = 4

    def kernels(prof):
        """Device activity (kernels, copies) by name, in ms per step."""
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
        return by

    def measure(name, state, s):
        state, _ = eng.step(tp, dp, state, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = eng.step(tp, dp, state, s)
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state, _ = eng.step(tp, dp, state, s)
        dev = kernels(prof)
        busy_ms = sum(dev.values())
        top_dev = sorted(dev.items(), key=lambda kv: kv[1], reverse=True)[:6]
        top_cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                         reverse=True)[:6]
        row = dict(
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            k1_ms=sum(t for k, t in dev.items()
                      if "verify_kernel" in k and "paged" not in k),
            paged_kernel_ms=sum(t for k, t in dev.items() if "paged_verify_kernel" in k),
            device_kernels=sum(1 for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
            top_device_ms={k[:60]: t for k, t in top_dev},
            top_host_ms={e.key[:60]: e.self_cpu_time_total / 1e3 / steps
                         for e in top_cpu})
        print("  " + json.dumps({"step": name, "s": s, **row}), flush=True)
        return row

    out = {}
    for s in (0, 3):
        out[f"ring_b8_s{s}"] = measure(f"ring_b8_s{s}",
                                       eng.prefill(tp, dp, toks, lens, 256), s)
    state = eng.init_slots(16, 512, block_size=16, num_blocks=192)
    ptoks = rng.integers(0, eng.tcfg.vocab_size, (16, 128)).astype(np.int32)
    for slot in range(16):
        state = eng.prefill_into(tp, dp, state, slot, ptoks[slot], 128, 512)
    out["paged_b16_s0"] = measure("paged_b16_s0", state, 0)
    check(all(v["device_busy_ms"] > 0 for v in out.values()),
          "the profiler saw no device time")
    check(out["paged_b16_s0"]["paged_kernel_ms"] > 0,
          "the profiler saw no paged kernel in the paged step")
    return out


# ---------------------------------------------------------------------------
# phase 6: the live continuous-batching runtime on the paged pool


def continuous_requests(np, Request, vocab, n, lens, max_new, interval, seed):
    """``n`` requests with random prompts of ``lens`` = (lo, hi) tokens,
    arriving every ``interval`` seconds of virtual time."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(lens[0], lens[1] + 1))
        out.append(Request(rid=i, arrival=interval * i,
                           tokens=rng.integers(0, vocab, L).astype(np.int32),
                           prompt_len=L, max_new=max_new))
    return out


def trace_signature(trace):
    """The scheduling decisions of a StepTrace, without its clock."""
    return [(t.occupancy, t.s, t.rids, t.committed, t.admitted, t.preempted, t.done_rids)
            for t in trace]


def phase_continuous_parity(torch, np, R, m):
    """fp32, the full-width pair cut to 2 layers: the paged live run, the
    contiguous live run and solo generate give the same tokens; the paged
    run preempts; its StepTrace replays on the sim backend; and the model's
    paged decode_step gives the same logits through K2 and K3."""
    import copy
    tcfg = R.get_config("opt-6.7b").with_(n_layers=2)
    dcfg = R.get_draft_config("opt-6.7b").with_(n_layers=2)
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=24, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    tp = eng.target.init(gen, torch.float32, "cuda")
    dp = eng.draft.init(gen, torch.float32, "cuda")
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 12, (8, 40), 24, 0.0, 21)
    ctrl = m.fixed_controller(3)
    geo = dict(capacity=8, cache_len=96)
    paged_geo = dict(block_size=16, num_blocks=12)
    runs = {}
    for name, kw in (("paged", paged_geo), ("contiguous", {})):
        be = m.ContinuousEngineBackend(eng, tp, dp, collect_outputs=True, warm_s=(3,),
                                       **geo, **kw)
        runs[name] = (m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp, ctrl,
                                              backend=be), be)
    res, be = runs["paged"]
    mismatched = []
    for r in reqs:
        solo, _, _ = eng.generate(tp, dp, r.tokens[None], np.array([r.prompt_len], np.int32),
                                  s=3, cache_len=96)
        outs = [runs[k][1].outputs[r.rid] for k in ("paged", "contiguous")]
        if not all(np.array_equal(o, solo[0][:r.max_new]) for o in outs):
            mismatched.append(r.rid)
    n_pre = sum(len(t.preempted) for t in res.trace)
    acc, dur, pre, done, chunk = m.replay_sources(res.trace)
    bs = (1, 2, 4, 8)
    model = m.LatencyModel(alpha={b: 1e-4 for b in bs}, beta={b: 5e-3 for b in bs},
                           t_s={b: 2e-4 for b in bs}, c=0.9, gamma=0.548)
    sim = m.ContinuousScheduler(
        m.SimStepBackend(model, capacity=8, accept_source=acc, duration_source=dur,
                         prefill_source=pre, done_source=done, chunk_source=chunk,
                         max_context=96, **paged_geo), ctrl)
    sim.run(copy.deepcopy(reqs))
    replay_equal = trace_signature(sim.trace) == trace_signature(res.trace)

    # the model's paged decode_step through K2 (no cu_blocks) and K3
    state = eng.init_slots(4, 96, block_size=16)
    for slot, r in enumerate(reqs[:3]):
        state = eng.prefill_into(tp, dp, state, slot, r.tokens, r.prompt_len, 96)
    pk = state.paged
    for slot in pk.active_slots():
        pk.ensure(slot, pk.tokens(slot) + 3)
    tables = pk.device_tables()
    state.tcache["bt"].copy_(torch.from_numpy(tables))
    cu = torch.from_numpy(m.host_cu_blocks(tables)).cuda()
    feed = torch.from_numpy(np.stack([r.tokens[:4] for r in reqs[:4]])).cuda()
    m.K23.DENSE.launches = 0
    lg_dense, _ = eng.target.decode_step(tp, feed, state.tcache, state.seq_lens)
    torch.cuda.synchronize()
    dense_launches = m.K23.DENSE.launches
    lg_ragged, _ = eng.target.decode_step(tp, feed, state.tcache, state.seq_lens, cu)
    model_equal = bool(torch.equal(lg_dense, lg_ragged))
    line = dict(requests=len(reqs), tokens_equal_paged_contiguous_solo=not mismatched,
                mismatched_rids=mismatched, preemptions=n_pre,
                steps=len(res.trace), sim_replay_equal=replay_equal,
                model_decode_k2_equals_k3=model_equal, k2_launches=dense_launches)
    print("  " + json.dumps(line), flush=True)
    check(not mismatched, f"paged / contiguous / solo tokens differ for rids {mismatched}")
    check(n_pre > 0, "the undersized pool never preempted")
    check(replay_equal, "the paged StepTrace differs from its SimStepBackend replay")
    check(model_equal, "the paged decode_step differs between K2 and K3")
    check(dense_launches > 0, "the paged decode_step without cu_blocks never launched K2")
    return line


def phase_continuous_serve(torch, np, R, m, lut_table):
    """bf16, full depth: serve_continuous_live on the paged pool with the
    LUT of phase 4; K3's launches, TTFT, ITL, tokens/s, preemptions, peak
    memory and the ragged against the dense grid steps.  The pool (144
    blocks of 16) admits more prompts than it can grow to their full
    length, so the run preempts and re-prefills from prompt + stash."""
    bf16 = torch.bfloat16
    tcfg, dcfg = R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b")
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    ctrl = m.AdaptiveController(lut=m.SpeculationLUT({int(b): int(v)
                                                      for b, v in lut_table.items()}))
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 32, (64, 192), 32, 0.05, 23)
    grid = {"ragged": 0, "dense": 0, "steps": 0}
    step = eng.step

    def counted_step(*a, **kw):   # host-side count of the grids the step used
        out = step(*a, **kw)
        if not kw.get("warm") and out[0].paged is not None:
            tabs = out[0].paged.device_tables(exclude_pending=True)
            grid["ragged"] += m.grid_steps_ragged(tabs)
            grid["dense"] += m.grid_steps_dense(tabs)
            grid["steps"] += 1
        return out
    eng.step = counted_step
    eng.load_kernels(paged=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (m.K1.KERNEL, m.K23.DENSE, m.K23.RAGGED, m.ops.PLAIN, m.paged.PLAIN):
        c.launches = 0
    t0 = time.perf_counter()
    res = m.serve_continuous_live(reqs, eng, tp, dp, ctrl, capacity=16, cache_len=512,
                                  block_size=16, num_blocks=144)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k1=m.K1.KERNEL.launches, k2=m.K23.DENSE.launches,
                    k3=m.K23.RAGGED.launches,
                    plain=m.ops.PLAIN.launches + m.paged.PLAIN.launches)
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    busy = sum(b.duration for b in res.batches)
    n_pre = sum(len(t.preempted) for t in res.trace)
    line = dict(
        requests=len(reqs), finished=len(done), wall_s=wall,
        ttft=dataclasses.asdict(m.ttft_summary(res)), itl=dataclasses.asdict(m.itl_summary(res)),
        tokens_per_s=sum(r.n_generated for r in res.requests) / busy,
        goodput=m.goodput(res), steps=len(res.batches),
        mean_occupancy=m.mean_occupancy(res),
        s_used=sorted({b.s_used for b in res.batches}),
        preemptions=n_pre,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        grid_steps_ragged=grid["ragged"], grid_steps_dense=grid["dense"],
        launches=launches)
    print("  " + json.dumps(line), flush=True)
    check(len(done) == len(reqs), f"{len(reqs) - len(done)} requests did not finish")
    check(n_pre > 0, "the paged pool never ran short: no request was preempted")
    check(launches["k3"] > 0, "the paged serving path never launched K3")
    check(launches["k1"] > 0, "the paged serving path never launched K1")
    check(launches["plain"] == 0, "a plain version ran on the card")
    return line


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the port's sources are not beside this script ({src})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    report = open(os.path.join(ROOT, "chiprun_out", "chip_smoke.log"), "w")
    sys.stdout = Tee(sys.__stdout__, report)
    import types

    import numpy as np
    from repro_torch.configs import registry as R
    from repro_torch.core import adaptive, analytical
    from repro_torch.core.spec_decode import SpecDecodeEngine
    from repro_torch.kernels import build, ops, paged, ref, tuning
    from repro_torch.kernels import paged_verify_attn as K23
    from repro_torch.kernels import spec_verify_attn as K1
    from repro_torch.launch import serve
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import metrics, scheduler
    from repro_torch.serving.request import Request

    # what phase 6 drives, under one name
    m = types.SimpleNamespace(
        SpecDecodeEngine=SpecDecodeEngine, Request=Request, K1=K1, K23=K23, ops=ops,
        paged=paged, host_cu_blocks=tuning.host_cu_blocks,
        grid_steps_ragged=tuning.grid_steps_ragged,
        grid_steps_dense=tuning.grid_steps_dense,
        AdaptiveController=adaptive.AdaptiveController,
        SpeculationLUT=adaptive.SpeculationLUT, fixed_controller=adaptive.fixed_controller,
        LatencyModel=analytical.LatencyModel,
        ContinuousEngineBackend=scheduler.ContinuousEngineBackend,
        ContinuousScheduler=scheduler.ContinuousScheduler,
        SimStepBackend=scheduler.SimStepBackend, replay_sources=scheduler.replay_sources,
        serve_continuous_live=scheduler.serve_continuous_live,
        ttft_summary=metrics.ttft_summary, itl_summary=metrics.itl_summary,
        goodput=metrics.goodput, mean_occupancy=metrics.mean_occupancy)

    def tree_to(tree, device):
        if isinstance(tree, dict):
            return {k: tree_to(v, device) for k, v in tree.items()}
        return tree.to(device)

    t_all = time.perf_counter()
    # ---- 1. device + build ----
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = build.build(["spec_verify_attn", "paged_verify_attn"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for p in libs.values()
             for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "device", "nvidia_smi": card,
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_s": build_s}), flush=True)
    for ln in ptxas:
        print("  ptxas: " + ln)

    # ---- 2. kernels ----
    rows = phase_kernels(torch, K1, ref)
    print(json.dumps({"phase": "kernels", "cases": len(rows), "ok": True}), flush=True)

    # ---- 2b. paged kernels ----
    prows = phase_paged_kernels(torch, np, K23, paged, ref)
    print(json.dumps({"phase": "paged_kernels", "cases": len(prows), "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 3. fp32 parity, card against CPU ----
    phase_parity(torch, np, R, DecoderLM, SpecDecodeEngine, tree_to)
    print(json.dumps({"phase": "parity", "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 4. the main path ----
    torch.cuda.reset_peak_memory_stats()
    K1.KERNEL.launches = 0
    ops.PLAIN.launches = 0
    res = serve.main(["--arch", "opt-6.7b", "--device", "cuda", "--dtype", "bfloat16",
                      "--max-batch", "8", "--cache-len", "256", "--profile-bs", "1,2,4,8",
                      "--s-max", "6", "--requests", "16", "--interval", "0.1",
                      "--max-new", "32"])
    torch.cuda.synchronize()
    launches, plain_launches = K1.KERNEL.launches, ops.PLAIN.launches
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["kernel_launches"] = launches
    res["plain_launches"] = plain_launches
    print(json.dumps({"phase": "serve", **res}), flush=True)
    check(launches > 0, "the serving path never launched the verify kernel")
    check(plain_launches == 0, "the plain version ran on the card")
    grid = [t for d in res["grid_s_per_token"].values() for t in d.values()]
    check(all(math.isfinite(t) and t > 0 for t in grid), "profiling grid not finite")
    check(res["adaptive"]["n"] == 16 and res["no_spec"]["n"] == 16,
          "not every request finished")
    check(math.isfinite(res["speedup"]), "speedup not finite")

    torch.cuda.empty_cache()

    # ---- 5. step profile (after the main path: its launches are not counted) ----
    phase_profile(torch, np, R, SpecDecodeEngine)
    print(json.dumps({"phase": "profile", "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 6a. continuous parity, fp32; K2's path: the paged decode_step ----
    cont = phase_continuous_parity(torch, np, R, m)
    print(json.dumps({"phase": "continuous_parity", "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 6b. the continuous main path, bf16, full depth ----
    live = phase_continuous_serve(torch, np, R, m, res["lut"])
    print(json.dumps({"phase": "continuous_serve", "ok": True}), flush=True)

    head = next(r for r in rows if r["case"] == "target_verify_s3_b8_bf16")
    phead = next(r for r in prows if r["case"] == "opt_pool_full_t1_bf16")
    paged_shape = "target verify s=0, " + phead["shape"] + ", bf16"
    paged_common = {"max_abs_err": phead["max_abs_err"], "plain_ms": phead["plain_ms"],
                    "bound_ms": phead["bound_ms"], "bound_by": phead["bound_by"],
                    "library_ms": phead["library_ms"], "library": phead["library"],
                    "shape": paged_shape}
    print(json.dumps({"kernels": [{
        "name": "spec_verify_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spec_verify_attn.cu",
        "replaces": "src/repro/kernels/spec_verify_attn.py:126",
        "launches": launches, "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": "target verify s=3, " + head["shape"] + ", bf16"
    }, {
        "name": "paged_verify_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_verify_attn.cu",
        "replaces": "src/repro/kernels/paged_verify_attn.py:206",
        "launches": cont["k2_launches"], "ms": phead["dense_ms"],
        "launches_from": "phase 6a, the model's paged decode_step without cu_blocks",
        **paged_common
    }, {
        "name": "ragged_paged_verify_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_verify_attn.cu",
        "replaces": "src/repro/kernels/paged_verify_attn.py:445",
        "launches": live["launches"]["k3"], "ms": phead["ms"],
        "launches_from": "phase 6b, serve_continuous_live on the paged pool",
        **paged_common}]}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
