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
            B = 16 draft decode; phase 6c's chunks: T 64 at offset 192 of a
            ring read through 256 rows, target and draft) plus GQA (G = 4,
            7, 10), window, prefix,
            fully masked rows, int8 + scales, ragged cache lengths, and
            long caches at small B whose key range is split across blocks
            (gated: they must split), in fp32 and bf16, with its time beside
            the plain version's, a library call's and the card's bound (the
            fp32 bound counted for its route, three tf32 products); each row
            gives its row tile, split count and the device kernels a call
            issues, all ``verify_kernel*``.
2b. paged   the paged kernels K2 (dense) and K3 (ragged) held against the
            plain gather path at the full-width OPT-6.7B verify (B 16,
            T 1, 4, 7, ragged tables with holes and an empty slot, and a
            full pool of 192 blocks), GQA at yi-9b widths and at G = 7
            and 10, window, prefix, int8 + scales, block size 8, all
            slots empty, one slot of 31 blocks (split across blocks), a
            chunked prefill's chunk (B 1, T 64 and 128 after 256 rows of
            context, and T 64 at G = 4) and the mixed verify+chunk launch
            (``mixed_*``: 15 slots verifying at s = 0 or 3 over 192 rows
            and one 64-row chunk after 256, padded to T 64, at G 1 and 4,
            beside the two-launch order it replaces; and at B 2, T 16,
            where the call splits), in fp32 and bf16; K3 must equal K2
            bit for bit, and each row gives its split count and the
            device kernels a call issues.
2c. train kernels  K4 (flash attention) and K5 (RMSNorm), forward and
            backward, held against their plain versions and autograd through
            the plain forward at the training shapes (internlm2-1.8b, the
            OPT-125M draft), the teacher's and ``prefill_flash``'s forward
            shapes in bf16, G = 7, 8 and 10, a window, a prefix, padded and
            fully masked rows and T not a multiple of the tile; with the
            times of the plain version, a library call (and the device
            kernels it runs) and the card's bound, K4's fp32 forward bound
            counted for its route (three tf32 products).  K5's backward
            also in bf16 (held against the plain backward on the same bf16
            inputs), at the card-vs-CPU train step's 128 rows and at odd
            widths (d 1000; d 1001, one-value accesses); two calls must
            agree bit for bit and issue the device kernels of the wrapper's
            plan, all ``rmsnorm_*``.
3. parity   full-width target and draft cut to 2 layers, fp32: prefill + 8
            greedy steps on the card (kernel) against the same on the CPU
            (plain version), and speculative generate(s) == generate(0).
4. serve    the paper's profile -> LUT -> adaptive serving loop
            (``repro_torch.launch.serve``) on the full-width OPT-6.7B +
            OPT-125M pair in bf16, with the kernel's launch count read
            around it.
5. profile  one serving step of that pair at B = 8, s = 0 and 3, and one
            paged step at B = 16: wall time against the device time
            ``torch.profiler`` sees; then one mixed verify+chunk step at
            B = 16 (a 64-token chunk of slot 15 inside the step of slots
            0-14) against the chunk on its own, then the step.
6a. continuous parity  the live continuous-batching runtime
            (``serve_continuous_live``) on the full-width pair cut to 2
            layers, fp32, with an undersized paged pool: tokens of the
            paged run, the contiguous run, both again with chunked prefill
            (``PrefillBudgetAdmit(16, chunk=8)``, a prompt over >= 3
            chunks), the paged chunked run again with the mixed
            verify+chunk launch, and each request's solo ``generate``
            identical, preemptions seen (the mixed run's too), the mixed
            run's StepTrace equal to the chunked run's but for durations
            and at least one chunk riding a step, every StepTrace (chunk
            events included) equal to its ``SimStepBackend`` replay, and
            the model's paged ``decode_step`` giving the same logits
            through K2 and K3.
6b. continuous serve  ``serve_continuous_live`` on the full-width pair in
            bf16 with phase 4's LUT: 16 slots, a paged pool of 144 blocks
            that runs short as requests grow, so running requests are
            preempted and re-prefilled; 32 requests; the ragged kernel's
            launches read around it.
6c. chunked serve  the same pair and pool with chunked prefill
            (``PrefillBudgetAdmit(128, chunk=64)``): 24 requests of 64-448
            prompt tokens, every request finished, prompts over >= 3
            chunks, the budget kept, the StepTrace replayed, K3 launched
            32 x (steps + chunks) times and no plain version; the same
            trace admitted whole beside it, and again with the mixed
            verify+chunk launch (every request finished, the StepTrace
            replayed, chunks riding steps, K3 launched 32 x (steps + final
            chunks + flushed chunks) times, no plain version; the mean
            host time of a mixed and of a plain step); then one 448-token
            prompt in 64-token chunks, on their own and through mixed
            steps beside 15 decoding slots, against ``prefill_into``, all
            in bf16, with the whole route in fp32 as the reference:
            positions equal, layer 0's K/V rows equal (reported for the
            mixed route), every layer's rows (through the slot's table)
            and the first step's logits no further from fp32 than the
            whole route's, 1.5x in relative RMS; the elementwise 1e-2
            comparison and the greedy tokens reported.
7.  train   the training path: the full-width OPT-125M draft distilled for
            20 steps against phase 4's OPT-6.7B teacher (the KL must fall;
            acceptance at s = 4 before and after); the internlm2-1.8b
            trainer (``repro_torch.launch.train``) at full width and depth,
            fp32, 20 steps, loss falling, K4/K5 launched and no plain
            version, peak memory and the device-busy share; one train step
            of internlm2 cut to 2 layers on the card against the CPU; and
            ``prefill_flash`` against ``prefill`` on OPT-6.7B, in fp32 (the
            bf16 weights cast: logits, every K/V row, K4 once per layer) and
            in bf16 (no further from the fp32 logits than ``prefill``).

2d. ssd kernel  K6 (the Mamba-2 SSD scan) held against its plain version at
            mamba2-1.3b's widths (64 heads, P 64, N 128, chunk 256): a
            B 4, T 2048 prefill with ragged dt masks (8 chunks), the
            one-chunk contract with a nonzero h0, T 300 (Q 150) and the
            prime T 257 (Q 1), the serving prefills (B 8, T 16; B 1, T 64,
            128, 256; a zero state, as the model passes it), strong decay
            (A 16, dt 0.1; outputs must be finite), the smoke widths and
            8 heads a group (G 8), in fp32 and bf16; two calls must agree
            bit for bit and issue the device kernels of the wrapper's rule,
            all ``ssd_*``; with its time beside the plain version's and the
            bound (its route: bf16, or fp32 as three tf32 products; no
            library call computes it).
8.  mamba2  Mamba-2 served by speculative decoding: mamba2-1.3b cut to 2
            layers (widths kept) with its draft cut to 2 layers, fp32, card
            against CPU (prefill of prompts padded to 512, 8 greedy steps),
            the chunked forward (K6) against the token-by-token recurrence,
            and speculative generate(s) == generate(0); then the serve loop
            of phase 4 on mamba2-1.3b at full width and depth in bf16 (K6,
            K5 and K1 counted, no plain version); then
            ``serve_continuous_live`` on a contiguous pool of 8 slots, 16
            requests of 64-256 prompt tokens, with that loop's LUT (K6
            counted inside ``prefill_into``), one step of that pair at
            B = 8, s = 0 and 3 under ``torch.profiler``, and one B = 1,
            T 256 target prefill under it (device time, K6's share).

Every serving phase now runs K5 (every norm), and phases 4, 6b and 8 gate
its launches; phase 5 records its time per step.

Exits non-zero, printing no verdict, without CUDA or when any phase fails.
Everything it prints also goes to ``chiprun_out/chip_smoke.log`` beside it,
since a remote run may return only the tail of standard output.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"float32": 67e12,        # fp32 outside the tensor cores
            "bfloat16": 989e12,      # dense bf16 tensor cores
            "tf32": 495e12}          # dense tf32 tensor cores (K1's and K4's fp32: 3 products)
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


def ptxas_report(text):
    """One line per kernel of an ``nvcc -Xptxas -v`` report: its name (the
    mangled name without its anonymous namespace) and its registers,
    spills, stack and shared memory."""
    out, name, facts = [], None, []
    for ln in text.splitlines() + ["Compiling entry function '' "]:
        if "Compiling entry function" in ln:
            if name:
                out.append(f"{name}: " + "; ".join(facts))
            name, facts = ln.split("'")[1], []
            if name.startswith("_ZN") and name[3:4].isdigit():   # skip _ZN<n><namespace>
                digits = len(name[3:]) - len(name[3:].lstrip("0123456789"))
                name = name[3 + digits + int(name[3:3 + digits]):]
        elif name and ("registers" in ln or "spill" in ln or "smem" in ln):
            facts.append(ln.split(":", 1)[-1].strip() if "ptxas info" in ln else ln.strip())
    return out


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
    against operations on the visible pairs, at the card's peaks.  The fp32
    kernel multiplies as three tf32 products, so its bound counts that route
    at the tf32 peak, with the fp32 SIMT figure beside it as
    ``bound_simt_ms``."""
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
    t_bytes = nbytes / HBM_BYTES_PER_S

    def least(t_ops, label):
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else label)
    simt = least(ops / PEAK_OPS[c["dtype"]], "operations")
    if c["dtype"] != "float32":
        return {"bound_ms": simt[0], "bound_by": simt[1]}
    ms, by = least(3 * ops / PEAK_OPS["tf32"], "operations")
    return {"bound_ms": ms, "bound_by": by, "bound_route": "3xTF32",
            "bound_simt_ms": simt[0]}


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


def kernel_name(name):
    """A device kernel's function name without its namespace, template
    arguments and parameters."""
    m = re.search(r"[A-Za-z_]\w*(?=[<(])", name)
    return m.group(0) if m else name


def device_kernels(torch, fn, args):
    """The names of the device kernels a call of ``fn`` launches
    (``torch.profiler``), in order, each once: the union over 3 calls,
    since the profiler now and then drops a call's device events."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(5):   # ... or hands back none at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return list(dict.fromkeys(names))


def run_kernel_case(torch, K1, ref, c):
    from repro_torch.kernels import launch
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
    del sets
    B, T, H, hd = c["q"].shape
    KVH, L = c["k"].shape[2], c["k"].shape[1]
    splits = K1.n_splits(B, KVH, (H // KVH) * T, L,
                         torch.cuda.get_device_properties(0).multi_processor_count)
    names = device_kernels(torch, kernel, args)
    # every device kernel of a call is K1's under phase 5's name filter
    names_ok = (len(names) == launch.device_kernels(splits)
                and all("verify_kernel" in n and "paged" not in n for n in names))
    return dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=max_err,
                tol=tol, ok=ok and names_ok, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, **bound(torch, c), row_tile=K1.row_tile((H // KVH) * T),
                n_splits=splits, device_kernels=len(names),
                kernel_names=[n.split("<")[0].split("::")[-1] for n in names])


def k1_specs():
    """Phase 2's K1 cases: (name, ``make_case`` keywords)."""
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
        # group sizes of yi-34b (G 7) and 10, where the folded rows span row
        # tiles: a verify and a B = 1 prefill each
        ("gqa_g7_verify_t4", dict(B=8, T=4, H=56, KVH=8, hd=128, L=L, n_ctx=150)),
        ("gqa_g7_prefill_t100", dict(B=1, T=100, H=56, KVH=8, hd=128, L=512, n_ctx=1,
                                     kv_len=90)),
        ("gqa_g10_verify_t4", dict(B=8, T=4, H=40, KVH=4, hd=128, L=L, n_ctx=150)),
        ("gqa_g10_prefill_t100", dict(B=1, T=100, H=40, KVH=4, hd=128, L=512, n_ctx=1,
                                      kv_len=90)),
        # chunked prefill on phase 6b's widths (DecoderLM.prefill_chunk): a
        # chunk of 64 rows at offset 192 of a slot's 512-row ring, attended
        # through its first R = 256 rows, for the target (a contiguous pool)
        # and the draft (its ring trails the paged target in phase 6c)
        ("chunk_target_t64_at192_r256", dict(B=1, T=64, H=T_H, KVH=T_KVH, hd=T_HD, L=256,
                                             n_ctx=193)),
        ("chunk_draft_t64_at192_r256", dict(B=1, T=64, H=D_H, KVH=D_KVH, hd=D_HD, L=256,
                                            n_ctx=193)),
        # one request decoding near the end of a 512-row ring: only the
        # splits fill the card
        ("b1_decode_l512", dict(B=1, T=1, H=T_H, KVH=T_KVH, hd=T_HD, L=512, n_ctx=500)),
        # phase 8's draft of mamba2-1.3b (dense_draft: 8 heads of 64, window
        # 4096) decoding over the continuous run's 8 slots of 512 rows
        ("mamba_draft_decode_t1_b8", dict(B=8, T=1, H=8, KVH=8, hd=64, L=512, n_ctx=200,
                                          window=4096)),
        ("mamba_draft_decode_t4_b8", dict(B=8, T=4, H=8, KVH=8, hd=64, L=512, n_ctx=200,
                                          window=4096)),
        # longer caches at small B, where the key range is split: both row
        # tiles, a wrapped ring with a window and GQA, int8, fully masked
        # rows and a prefix through the splits and the combine
        ("split_b1_decode_l4096", dict(B=1, T=1, H=T_H, KVH=T_KVH, hd=T_HD, L=4096,
                                       n_ctx=4000)),
        ("split_b1_prefill_t256_l1024", dict(B=1, T=256, H=T_H, KVH=T_KVH, hd=T_HD, L=1024,
                                             n_ctx=768)),
        ("split_gqa_g4_window_l2048", dict(B=1, T=9, H=32, KVH=8, hd=128, L=2048, n_ctx=3000,
                                           window=600)),
        ("split_int8_l2048", dict(B=1, T=4, H=T_H, KVH=T_KVH, hd=T_HD, L=2048, n_ctx=1500,
                                  quant=True)),
        ("split_masked_l1024", dict(B=2, T=4, H=D_H, KVH=D_KVH, hd=D_HD, L=1024, n_ctx=900,
                                    masked_row=True)),
        ("split_prefix_l1024", dict(B=2, T=4, H=D_H, KVH=D_KVH, hd=D_HD, L=1024, n_ctx=1000,
                                    prefix_len=16)),
    ]
    return specs


def phase_kernels(torch, K1, ref):
    rows = []
    for i, (name, kw) in enumerate(k1_specs()):
        for dtype in ("float32", "bfloat16"):
            c = make_case(torch, f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                          dtype=dtype, seed=i, **kw)
            r = run_kernel_case(torch, K1, ref, c)
            rows.append(r)
            print("  " + json.dumps(r), flush=True)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version or runs another "
                   f"kernel: {bad}")
    check(all(r["n_splits"] > 1 for r in rows
              if r["case"].startswith(("b1_decode_l512", "split_"))),
          "a case meant to split the key range did not")
    return rows


# ---------------------------------------------------------------------------
# phase 2b: the paged kernels K2 and K3 against the plain gather path


def make_paged_case(torch, np, name, *, B, T, H, KVH, hd, bs, MAXB, ctx, dtype,
                    holes=(), window=None, prefix_len=0, quant=False, seed=0, lens=None):
    """A pool as the paged engine leaves it before the verify attention:
    slot b's rows hold positions 0 .. ctx[b] + T - 2 (its context and this
    step's T query rows) in blocks taken from a shuffled pool, with the
    (slot, logical block) entries in ``holes`` set to -1 and left unowned.
    ctx[b] = 0 is an empty slot: table row all -1, queries at 1 .. T as the
    engine gives them.  Spare blocks and the trash block hold garbage rows
    and positions that no table names.  ``lens[b]`` (the mixed launch's
    layout) gives slot b only its first ``lens[b]`` query columns: its rows
    end at ctx[b] + lens[b] - 2 and the other columns are padding at
    position -1."""
    from repro_torch.kernels.tuning import host_cu_blocks
    rng = np.random.default_rng(seed)
    lens = [T] * B if lens is None else lens
    need = [-(-(n + t - 1) // bs) if n else 0 for n, t in zip(ctx, lens)]
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
            pos[pb] = np.where(rows < n + lens[b] - 1, rows, -1)
    q_pos = np.stack([np.where(np.arange(T) < t, np.arange(T) + (n - 1 if n else 1), -1)
                      for n, t in zip(ctx, lens)]).astype(np.int32)
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
                      f"live blocks {int((bt >= 0).sum())}"
                      + (f" real rows {sum(lens)}" if sum(lens) < B * T else ""))


def paged_bound(torch, paged, c):
    """Least time for one paged verify call: q and out of the real query
    rows (position >= 0; the mixed launch's padding changes nothing),
    q_pos, the table (and cu_blocks), the positions of every owned block,
    and the K/V (and scales) of the owned blocks some query sees, against
    the operations on the visible (query, key) pairs."""
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
    real = int((c["q_pos"] >= 0).sum())
    nbytes = (vis_blocks * bs * per_row + 2 * real * H * hd * q.element_size()
              + 4 * (c["q_pos"].numel() + c["bt"].numel() + c["cu"].numel()
                     + owned * bs))
    ops = 4 * int(ok.sum()) * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[c["dtype"]]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_paged_case(torch, K23, paged, ref, c):
    import torch.nn.functional as F

    from repro_torch.kernels import launch
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
    B, T, H, hd = c["q"].shape
    KVH, bs, MAXB = c["k"].shape[2], c["k"].shape[1], c["bt"].shape[1]
    splits = K23.n_splits(B, KVH, (H // KVH) * T, MAXB, bs,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    names = device_kernels(torch, ragged, args)
    # every device kernel of a call is K3's under phase 5's name filter
    names_ok = (len(names) == launch.device_kernels(splits)
                and all("paged_verify_kernel" in n for n in names))
    return dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=max_err,
                tol=tol, ok=ok and same and zero_rows and names_ok, k3_equals_k2=same,
                empty_rows_zero=zero_rows, n_splits=splits, device_kernels=len(names),
                kernel_names=[n.split("<")[0].split("::")[-1] for n in names],
                ms=ragged_ms, dense_ms=dense_ms,
                plain_ms=plain_ms, library_ms=library_ms, library="gather + SDPA (two calls)",
                bound_ms=bound_ms, bound_by=bound_by)


def _mixed_cases():
    opt = dict(H=32, KVH=32, hd=128, bs=16, MAXB=32)
    # slots 0-14 verify at s = 0 or 3 with the full pool's contexts, slot 15
    # carries a 64-row chunk after 256 rows of context, all padded to Tm = 64
    cases = [(f"mixed_b16_t64_s{s}{tag}", dict(B=16, T=64, ctx=[192] * 15 + [257],
                                               lens=[s + 1] * 15 + [64], mixed_slot=15,
                                               **heads))
             for tag, heads in (("", opt), ("_gqa_g4", dict(opt, KVH=8))) for s in (0, 3)]
    # the same at B 2, T 16: few enough blocks that the call splits, so the
    # padding-only tiles write their empty partials for the ordered combine
    cases.append(("mixed_b2_t16_s0_gqa_g4", dict(B=2, T=16, ctx=[192, 257], lens=[1, 16],
                                                 mixed_slot=1, **dict(opt, KVH=8))))
    return cases


# phase 2b's mixed verify+chunk launch (phase 6c with mixed_launch=True):
# (name, make_paged_case arguments + the chunk's slot ``mixed_slot``)
MIXED_CASES = _mixed_cases()


def run_mixed_case(torch, K23, paged, ref, c, slot):
    """A mixed verify+chunk call (slot ``slot`` carries the chunk, every
    other slot its verify columns; ``make_paged_case`` with ``lens``) as
    ``run_paged_case`` runs it, beside the two-launch order it replaces:
    K3 at the verify's ``[B, s + 1]`` (the pending slot's table row -1, as
    the device table has it) plus K3 at the chunk's ``[1, T]`` through its
    own row, each timed on its own and added."""
    from repro_torch.kernels.tuning import host_cu_blocks
    r = run_paged_case(torch, K23, paged, ref, c)
    vl = int((c["q_pos"][0] >= 0).sum())
    tab_v = c["tables"].copy()
    tab_v[slot] = -1
    bt_v = torch.from_numpy(tab_v).cuda()
    cu_v = torch.from_numpy(host_cu_blocks(tab_v)).cuda()
    q_pos_v = c["q_pos"][:, :vl].clone()
    q_pos_v[slot] = torch.arange(vl, device="cuda", dtype=torch.int32) + 4096   # parked
    parts = {
        "verify": (c["q"][:, :vl].contiguous(), q_pos_v, bt_v, cu_v),
        "chunk": (c["q"][slot:slot + 1].contiguous(), c["q_pos"][slot:slot + 1].contiguous(),
                  c["bt"][slot:slot + 1].contiguous(),
                  torch.from_numpy(host_cu_blocks(c["tables"][slot:slot + 1])).cuda()),
    }
    kw = dict(window=c["window"], prefix_len=c["prefix_len"])

    def ragged(q, k, v, qp, pos, bt, cu):
        return K23.ragged_paged_verify_attn_cuda(q, k, v, qp, pos, bt, cu, **kw)
    ms = {}
    for name, (q, qp, bt, cu) in parts.items():
        args = (q, c["k"], c["v"], qp, c["pos"], bt, cu)
        sets = [tuple(x.clone() for x in args) for _ in range(2)]
        ms[name] = device_ms(torch, ragged, sets)
        del sets
    r.update(verify_call_ms=ms["verify"], chunk_call_ms=ms["chunk"],
             two_launch_ms=ms["verify"] + ms["chunk"],
             mixed_over_two_launch=r["ms"] / (ms["verify"] + ms["chunk"]))
    return r


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
        # group sizes of yi-34b (G 7) and 10, where the folded rows span tiles
        ("gqa_g7_t4", dict(B=8, T=4, H=56, KVH=8, hd=128, bs=16, MAXB=32,
                           ctx=ragged_ctx(8, 4), holes=((3, 0), (6, 1)))),
        ("gqa_g10_t4", dict(B=8, T=4, H=40, KVH=4, hd=128, bs=16, MAXB=32,
                            ctx=ragged_ctx(8, 4), holes=((2, 0), (5, 1)))),
        # one slot near phase 6b's 512-row cap: only the splits fill the card
        ("b1_t1_31_blocks", dict(B=1, T=1, ctx=[496], **opt)),
        # a chunked prefill's target chunk (phase 6c; DecoderLM.prefill_chunk
        # on the paged pool): one slot, T query rows after 256 rows of context
        ("opt_chunk_t64", dict(B=1, T=64, ctx=[257], **opt)),
        ("opt_chunk_t128", dict(B=1, T=128, ctx=[257], **opt)),
        ("gqa_g4_chunk_t64", dict(B=1, T=64, H=32, KVH=8, hd=128, bs=16, MAXB=32, ctx=[257])),
    ]
    specs += MIXED_CASES
    rows = []
    for i, (name, kw) in enumerate(specs):
        kw = dict(kw)
        mixed_slot = kw.pop("mixed_slot", None)
        for dtype in ("float32", "bfloat16"):
            c = make_paged_case(torch, np, f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                                dtype=dtype, seed=100 + i, **kw)
            r = (run_paged_case(torch, K23, paged, ref, c) if mixed_slot is None
                 else run_mixed_case(torch, K23, paged, ref, c, mixed_slot))
            rows.append(r)
            print("  " + json.dumps(r), flush=True)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"paged kernels disagree with the plain path or K3 != K2: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 2c: K4 (flash attention) and K5 (RMSNorm), forward and backward,
# against their plain versions


GRAD_TOL = 1e-4   # fp32 grads: the same math, sums over up to 1024 rows in another order
# bf16 grads: each of dq, dk, dv at most this many times as far, in relative
# RMS, from the fp32 autograd gradients as SDPA's bf16 backward on the same
# bf16 inputs (phase 7's rule for prefill_flash's bf16 logits)
BF16_GRAD_RMS_RATIO = 1.5


def rel_rms(x, want):
    """Relative RMS error of ``x`` against ``want`` (fp32)."""
    return float((x.float() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def within(torch, got, want, tol):
    """Max abs error and whether |got - want| <= tol + tol * |want| holds
    everywhere; -inf (a fully masked row's logsumexp) must match exactly."""
    got, want = got.float(), want.float()
    inf = torch.isinf(want)
    ok = bool(torch.equal(torch.isinf(got), inf)) and bool((got[inf] == want[inf]).all())
    err = (got[~inf] - want[~inf]).abs()
    ok &= bool((err <= tol + tol * want[~inf].abs()).all())
    return (float(err.max()) if err.numel() else 0.0), ok


def make_flash_case(torch, name, *, B, T, H, KVH, hd, dtype, lens=None, window=None,
                    prefix_len=0, grads=True, seed=0):
    """Self-attention inputs as the training forward and ``prefill_flash``
    give them: q [B,T,H,hd], k/v [B,T,KVH,hd], positions 0..T-1 per row, and
    with ``lens`` the rows at or past a row's length set to -1 (a length of 0
    makes every row of that batch entry fully masked)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dt)

    pos = torch.arange(T, device="cuda", dtype=torch.int32).expand(B, T).contiguous()
    if lens is not None:
        n = torch.tensor(lens, device="cuda", dtype=torch.int32)[:, None]
        pos = torch.where(pos < n, pos, -1).contiguous()
    return dict(name=name, q=rnd(B, T, H, hd), k=rnd(B, T, KVH, hd), v=rnd(B, T, KVH, hd),
                do=rnd(B, T, H, hd), pos=pos, window=window, prefix_len=prefix_len,
                dtype=dtype, grads=grads,
                shape=f"B{B} T{T} H{H}/{KVH}x{hd}" + (f" lens {lens}" if lens else "")
                      + (f" window {window}" if window else "")
                      + (f" prefix {prefix_len}" if prefix_len else ""))


def flash_bound(torch, c, backward):
    """Least time, as the row's ``bound_ms``/``bound_by`` (``bwd_``-prefixed
    for the backward): the bytes moved once against the operations on the
    visible (query, key) pairs.  Bytes: q (with o and dO backward) only of
    query rows that see some key, k and v only of key rows some query sees
    (no other row changes the result), positions, and every output row
    (out and lse; dq, dk, dv) with lse read backward.  Operations: 4 flop
    per pair, head and hd forward (QK^T, PV), 10 backward (QK^T and dO V^T
    recomputed, dV, dQ, dK), at the dtype's peak; fp32, forward and
    backward, counts its route, three tf32 products at the tf32 peak, with
    the fp32 SIMT figure beside it as ``bound_simt_ms`` (``bwd_bound_simt_ms``)."""
    q, k = c["q"], c["k"]
    B, T, H, hd = q.shape
    KVH = k.shape[2]
    ok = visible(torch, dict(c, q_pos=c["pos"], k_pos=c["pos"]))      # [B, T, L]
    pairs = int(ok.sum())
    es = q.element_size()
    q_need = int(ok.any(2).sum()) * H * hd * es
    kv_need = 2 * int(ok.any(1).sum()) * KVH * hd * es
    qb, kb, lse_b, pos_b = q.numel() * es, k.numel() * es, 4 * B * H * T, 8 * c["pos"].numel()
    if backward:
        nbytes = 3 * q_need + kv_need + lse_b + qb + 2 * kb + pos_b   # in; dq dk dv out
        ops = 10 * pairs * H * hd
    else:
        nbytes = q_need + kv_need + qb + lse_b + pos_b                 # in; out, lse out
        ops = 4 * pairs * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S

    def least(t_ops, label):
        return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else label)
    pre = "bwd_" if backward else ""
    simt = least(ops / PEAK_OPS[c["dtype"]], "operations")
    if c["dtype"] != "float32":
        return {pre + "bound_ms": simt[0], pre + "bound_by": simt[1]}
    if backward:
        ms, by = least(3 * ops / PEAK_OPS["tf32"], "operations")
        return {"bwd_bound_ms": ms, "bwd_bound_by": by, "bwd_bound_route": "3xTF32",
                "bwd_bound_simt_ms": simt[0]}
    ms, by = least(3 * ops / PEAK_OPS["tf32"], "operations (3xTF32)")
    return {"bound_ms": ms, "bound_by": by, "bound_simt_ms": simt[0]}


def run_flash_case(torch, K4, ref, c):
    import torch.nn.functional as F
    kw = dict(window=c["window"], prefix_len=c["prefix_len"])
    q, k, v, do, pos = c["q"], c["k"], c["v"], c["do"], c["pos"]
    G = q.shape[2] // k.shape[2]
    tol = TOL[c["dtype"]]
    out, lse = K4.flash_attn_fwd_cuda(q, k, v, pos, pos, save_lse=True, **kw)
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v, do)]
    want, want_lse = ref.flash_attn_fwd_lse_ref(f32[0], f32[1], f32[2], pos, pos, **kw)
    err, ok = within(torch, out, want, tol)
    lse_err, lse_ok = within(torch, lse, want_lse, tol)
    zero = pos < 0 if not c["prefix_len"] else torch.zeros_like(pos, dtype=torch.bool)
    ok &= lse_ok and bool((out[zero] == 0).all())                 # masked rows give zeros
    row = dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=err,
               lse_max_abs_err=lse_err, tol=tol)
    case_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, do, out))
    copies = min(64, max(2, math.ceil(2 * 50e6 / case_bytes)))
    sets = [tuple(x.clone() for x in (q, k, v, pos, out, do, lse)) for _ in range(copies)]
    mask = lambda p: visible(torch, dict(c, q_pos=p, k_pos=p))[:, None]  # noqa: E731
    row["ms"] = device_ms(torch, lambda q, k, v, p, *_: K4.flash_attn_fwd_cuda(
        q, k, v, p, p, save_lse=True, **kw), sets)
    row["plain_ms"] = device_ms(torch, lambda q, k, v, p, *_: ref.flash_attn_fwd_lse_ref(
        q, k, v, p, p, **kw), sets)
    lib_sets = [(s[0].transpose(1, 2), s[1].transpose(1, 2), s[2].transpose(1, 2),
                 mask(s[3])) for s in sets]
    sdpa = lambda q, k, v, m: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=m, enable_gqa=G > 1)
    row["library_ms"] = device_ms(torch, sdpa, lib_sets)
    row["library_kernels"] = [n[:90] for n in device_kernels(torch, sdpa, lib_sets[0])]
    row.update(flash_bound(torch, c, False))
    if c["grads"]:
        def bwd(q, k, v, p, o, d, l):
            return K4.flash_attn_bwd_cuda(q, k, v, o, d, l, p, p, **kw)

        def sdpa_fwd_bwd(q, k, v, m, d):
            leaf = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaf, attn_mask=m, enable_gqa=G > 1)
            return torch.autograd.grad(o, leaf, d)
        args = (q, k, v, pos, out, do, lse)
        grads = bwd(*args)
        again = bwd(*args)
        torch.cuda.synchronize()
        row["bwd_bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(grads, again))
        ok &= row["bwd_bitwise_repeatable"]
        leaf = [x.clone().requires_grad_(True) for x in f32[:3]]
        auto = torch.autograd.grad(ref.gqa_masked_ref(*leaf, pos, pos, **kw), leaf, f32[3])
        if c["dtype"] == "float32":
            explicit = ref.flash_attn_bwd_ref(*f32[:3], want, f32[3], want_lse, pos, pos, **kw)
            errs = []
            for got, e, a in zip(grads, explicit, auto):
                e1, ok1 = within(torch, got, e, GRAD_TOL)
                e2, ok2 = within(torch, got, a, GRAD_TOL)
                errs.append(max(e1, e2))
                ok &= ok1 and ok2
            row["grad_max_abs_err"] = max(errs)
            row["grad_tol"] = GRAD_TOL
        else:
            lib = [g.transpose(1, 2) for g in sdpa_fwd_bwd(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask(pos),
                do.transpose(1, 2))]
            names3 = ("dq", "dk", "dv")
            row["grad_rel_rms"] = {n: rel_rms(g, a) for n, g, a in zip(names3, grads, auto)}
            row["sdpa_grad_rel_rms"] = {n: rel_rms(g, a) for n, g, a in zip(names3, lib, auto)}
            row["grad_max_abs_err"] = max(float((g.float() - a).abs().max())
                                          for g, a in zip(grads, auto))
            row["grad_rms_ratio_limit"] = BF16_GRAD_RMS_RATIO
            ok &= all(row["grad_rel_rms"][n] <= BF16_GRAD_RMS_RATIO * row["sdpa_grad_rel_rms"][n]
                      for n in names3)
        B, T, H, _ = q.shape
        KVH = k.shape[2]
        splits = K4.bwd_n_splits(B, KVH, (H // KVH) * T, T,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
        names = device_kernels(torch, bwd, args)
        row["bwd_n_splits"] = splits
        row["bwd_device_kernels"] = len(names)
        row["bwd_kernel_names"] = [n.split("<")[0].split("::")[-1] for n in names]
        ok &= (len(names) == K4.bwd_device_kernels(splits)
               and all("flash_bwd" in n for n in names))
        row["bwd_ms"] = device_ms(torch, bwd, sets)
        row["bwd_plain_ms"] = device_ms(torch, lambda q, k, v, p, o, d, l: ref.flash_attn_bwd_ref(
            q, k, v, o, d, l, p, p, **kw), sets)
        # 10 calls: autograd's host time per call must stay inside device_ms's sleep
        row["bwd_library_ms"] = device_ms(torch, sdpa_fwd_bwd, [
            (*ls, s[5].transpose(1, 2)) for ls, s in zip(lib_sets, sets)], iters=10)
        row["fwd_plus_bwd_ms"] = row["ms"] + row["bwd_ms"]
        row.update(flash_bound(torch, c, True))
    row["ok"] = ok
    del sets, lib_sets
    return row


def run_norm_case(torch, K5, ref, name, n, d, dtype, grads, seed):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (3 * torch.randn((n, d), generator=g, device="cuda")).to(dt)
    gamma = (1 + 0.1 * torch.randn((d,), generator=g, device="cuda")).to(dt)
    dy = torch.randn((n, d), generator=g, device="cuda").to(dt)
    tol = TOL[dtype]
    y, rstd = K5.rmsnorm_fwd_cuda(x, gamma, save_rstd=True)
    torch.cuda.synchronize()
    # the plain version in the kernel's dtype: the cast before gamma is part
    # of the contract, so bf16 is held against the bf16 plain run
    err, ok = within(torch, y, ref.rmsnorm_ref(x, gamma), tol)
    row = dict(case=name, dtype=dtype, shape=f"n{n} d{d}", max_abs_err=err, tol=tol)
    nb = x.element_size()
    copies = min(64, max(2, math.ceil(2 * 50e6 / (3 * n * d * nb))))
    sets = [tuple(t.clone() for t in (x, gamma, dy, rstd)) for _ in range(copies)]
    row["ms"] = device_ms(torch, lambda x, gm, *_: K5.rmsnorm_fwd_cuda(x, gm, save_rstd=True),
                          sets)
    row["plain_ms"] = device_ms(torch, lambda x, gm, *_: ref.rmsnorm_ref(x, gm), sets)
    row["library_ms"] = device_ms(torch, lambda x, gm, *_: F.rms_norm(x, (d,), gm, 1e-6), sets)
    t_bytes = (2 * n * d + d) * nb / HBM_BYTES_PER_S + 4 * n / HBM_BYTES_PER_S
    t_ops = 4 * n * d / PEAK_OPS["float32"]
    row["bound_ms"], row["bound_by"] = 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")
    if grads:
        bwd = K5.rmsnorm_bwd_cuda
        args = (x, gamma, dy, rstd)
        grads_ = bwd(*args)
        again = bwd(*args)
        torch.cuda.synchronize()
        row["bwd_bitwise_repeatable"] = all(torch.equal(a, b) for a, b in zip(grads_, again))
        ok &= row["bwd_bitwise_repeatable"]
        if dtype == "float32":
            x32, g32, dy32 = x.float(), gamma.float(), dy.float()
            leaf = [x32.clone().requires_grad_(True), g32.clone().requires_grad_(True)]
            wants = (ref.rmsnorm_bwd_ref(x32, g32, dy32),
                     torch.autograd.grad(ref.rmsnorm_ref(*leaf), leaf, dy32))
            gtol = GRAD_TOL
        else:
            # bf16: held against the plain backward on the same bf16 inputs,
            # not fp32 autograd: dgamma sums 1024 rows of dy * xh.to(bf16),
            # whose rounding of xh alone moves a near-zero entry by ~0.03;
            # here only the summation order and the final rounding differ
            wants, gtol = (ref.rmsnorm_bwd_ref(x, gamma, dy),), tol
        errs = []
        for want in wants:
            for got, w in zip(grads_, want):
                e, ok1 = within(torch, got, w, gtol)
                errs.append(e)
                ok &= ok1
        row["grad_max_abs_err"], row["grad_tol"] = max(errs), gtol
        plan = K5.bwd_plan(n, d, torch.cuda.get_device_properties(0).multi_processor_count,
                           nb)
        names = device_kernels(torch, bwd, args)
        row["bwd_plan"] = {k: plan[k] for k in K5.BWD_ARGS + ("combine_blocks",)}
        row["bwd_device_kernels"] = len(names)
        row["bwd_kernel_names"] = [kernel_name(n_) for n_ in names]
        ok &= len(names) == plan["device_kernels"] and all("rmsnorm" in n_ for n_ in names)
        row["bwd_ms"] = device_ms(torch, bwd, sets)
        row["bwd_plain_ms"] = device_ms(torch, lambda x, gm, d_, r: ref.rmsnorm_bwd_ref(
            x, gm, d_), sets)

        def lib_fwd_bwd(x, gm, d_, r):
            leaf = [x.detach().requires_grad_(True), gm.detach().requires_grad_(True)]
            return torch.autograd.grad(F.rms_norm(leaf[0], (d,), leaf[1], 1e-6), leaf, d_)
        row["bwd_library_ms"] = device_ms(torch, lib_fwd_bwd, sets)
        row["fwd_plus_bwd_ms"] = row["ms"] + row["bwd_ms"]
        t_bytes = ((3 * n * d + 2 * d) * nb + 4 * n) / HBM_BYTES_PER_S   # x dy dx; gamma dgamma
        t_ops = 8 * n * d / PEAK_OPS["float32"]
        row["bwd_bound_ms"], row["bwd_bound_by"] = 1e3 * max(t_bytes, t_ops), (
            "bytes" if t_bytes >= t_ops else "operations")
    row["ok"] = ok
    del sets
    return row


# K4's phase 2c cases: (name, make_flash_case arguments)
FLASH_CASES = [
    # internlm2-1.8b training and the card-vs-CPU step (fwd + bwd)
    ("internlm2_train", dict(B=8, T=128, H=16, KVH=8, hd=128, dtype="float32")),
    ("internlm2_cpu_step", dict(B=2, T=64, H=16, KVH=8, hd=128, dtype="float32")),
    # OPT-125M distillation (fwd + bwd), OPT-6.7B teacher (fwd, bf16)
    ("opt125m_distill", dict(B=8, T=128, H=12, KVH=12, hd=64, dtype="float32")),
    ("opt67b_teacher", dict(B=8, T=128, H=32, KVH=32, hd=128, dtype="bfloat16",
                            grads=False)),
    # prefill_flash: prompts right-padded with -1 rows (bf16, fwd)
    ("prefill_flash_t512", dict(B=4, T=512, H=32, KVH=32, hd=128, dtype="bfloat16",
                                lens=[512, 400, 301, 77], grads=False)),
    ("prefill_flash_draft", dict(B=2, T=200, H=12, KVH=12, hd=64, dtype="bfloat16",
                                 lens=[200, 133], grads=False)),
    # contract cases: G = 8 (yi-9b), window, prefix, padding and a fully
    # masked batch entry, T not a multiple of the 64-row tile
    ("gqa_g8", dict(B=2, T=128, H=32, KVH=4, hd=128, dtype="float32")),
    ("gqa_g8_bf16", dict(B=2, T=128, H=32, KVH=4, hd=128, dtype="bfloat16")),
    ("window_48", dict(B=2, T=160, H=16, KVH=8, hd=128, dtype="float32", window=48)),
    ("prefix_16", dict(B=2, T=96, H=16, KVH=8, hd=128, dtype="float32", prefix_len=16)),
    ("padded_masked", dict(B=3, T=128, H=12, KVH=12, hd=64, dtype="float32",
                           lens=[128, 0, 70])),
    ("ragged_t100", dict(B=3, T=100, H=16, KVH=8, hd=128, dtype="float32",
                         lens=[100, 93, 41])),
    # G = 7 (yi-34b's grouping: a 64-row tile holds parts of two heads) and
    # G = 10, each in fp32 and bf16 with grads
    ("gqa_g7", dict(B=2, T=100, H=56, KVH=8, hd=128, dtype="float32")),
    ("gqa_g7_bf16", dict(B=2, T=100, H=56, KVH=8, hd=128, dtype="bfloat16")),
    ("gqa_g10", dict(B=2, T=128, H=40, KVH=4, hd=128, dtype="float32")),
    ("gqa_g10_bf16", dict(B=2, T=128, H=40, KVH=4, hd=128, dtype="bfloat16")),
    # the trainer's shape in bf16 (fwd + bwd): the bf16 backward gate
    ("internlm2_train_bf16", dict(B=8, T=128, H=16, KVH=8, hd=128, dtype="bfloat16")),
]


def phase_train_kernels(torch, K4, K5, ref):
    rows = []
    for i, (name, kw) in enumerate(FLASH_CASES):
        r = run_flash_case(torch, K4, ref, make_flash_case(torch, "flash_" + name,
                                                           seed=200 + i, **kw))
        rows.append(r)
        print("  " + json.dumps(r), flush=True)
    norms = [("internlm2_train", 1024, 2048, "float32", True),
             ("opt125m_distill", 1024, 768, "float32", True),
             ("internlm2_train_bf16", 1024, 2048, "bfloat16", True),
             ("opt67b_teacher", 1024, 4096, "bfloat16", False),
             ("opt67b_serve_b8_t4", 32, 4096, "bfloat16", False),
             ("opt125m_serve_b16_t1", 16, 768, "bfloat16", False),
             ("opt67b_prefill_t256", 256, 4096, "bfloat16", False),
             # the card-vs-CPU train step's rows (B 2, T 64): one row a unit;
             # rows and width that fill no access pattern evenly (d 1000: 250
             # 16-byte accesses over 128 threads); d 1001: one-value accesses
             ("small_n128", 128, 2048, "float32", True),
             ("odd_d1000", 257, 1000, "float32", True),
             ("odd_d1001_bf16", 257, 1001, "bfloat16", True)]
    for i, (name, n, d, dtype, grads) in enumerate(norms):
        r = run_norm_case(torch, K5, ref, "rmsnorm_" + name, n, d, dtype, grads, 300 + i)
        rows.append(r)
        print("  " + json.dumps(r), flush=True)
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, f"K4/K5 disagree with their plain versions: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 2d: K6 (the Mamba-2 SSD scan) against its plain version


SSD_TOL = {"float32": 2e-4,    # the JAX package's own K6 tolerance (tests/test_kernels.py)
           "bfloat16": 1e-2}   # bf16 inputs; both sides compute in fp32


def make_ssd_case(torch, name, *, B, T, H=64, P=64, G=1, N=128, dtype, chunk=256, lens=None,
                  strong=False, h0=False, contract=False, seed=0):
    """Inputs as a Mamba-2 prefill gives them to the scan: xh [B,T,H,P] and
    B/C [B,T,G,N] of conv-and-SiLU magnitude, dt = softplus(noise + the
    init's dt_bias) (1e-3 to 1e-1 over the heads), A = 1 .. 16 over the
    heads, and dt = 0 at or past a row's length (``lens``).  ``strong``:
    A = 16 and dt = 0.1 everywhere (cs falls to about -410 over 256 rows).
    ``contract``: the one-chunk contract [B*H, T, ...] with an explicit
    log-decay; ``h0``: a nonzero carried-in state, else None (a zero
    state, as the model's prefill passes it)."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)

    xh = F.silu(rnd(B, T, H, P)).to(dt_)
    Bm, Cm = (F.silu(rnd(B, T, G, N)).to(dt_) for _ in range(2))
    bias = torch.log(torch.expm1(torch.exp(torch.linspace(
        math.log(1e-3), math.log(1e-1), H, device="cuda"))))
    dt = F.softplus(0.5 * rnd(B, T, H) + bias)
    A = torch.linspace(1.0, 16.0, H, device="cuda")
    if strong:
        dt, A = torch.full_like(dt, 0.1), torch.full_like(A, 16.0)
    if lens is not None:
        n = torch.tensor(lens, device="cuda")[:, None, None]
        dt = torch.where(torch.arange(T, device="cuda")[None, :, None] < n, dt, 0.0)
    hinit = (0.5 * rnd(B, H, P, N)) if h0 else None
    return dict(name=name, xh=xh, B=Bm, C=Cm, dt=dt.contiguous(), A=A, h0=hinit, chunk=chunk,
                dtype=dtype, contract=contract,
                shape=f"B{B} T{T} H{H} P{P} G{G} N{N} chunk {chunk}"
                      + (f" lens {lens}" if lens else "") + (" strong decay" if strong else "")
                      + (" h0" if h0 else " zero state")
                      + (" one-chunk contract" if contract else ""))


def ssd_bound(torch, ref, c):
    """Least time for the scan, as the row's ``bound_ms``/``bound_by``: every
    input read once (h0 only when given) and y and the final state written
    once, against the operations the function needs per (batch, chunk): c b^T
    over the causal half once per group (its heads share it), then per head
    the decayed scores times x and the state update, and the carried-in
    state's term when h0 is given (with several chunks, in every chunk
    after the first).  bf16 at the bf16 peak; fp32 counts its route, three
    tf32 products at the tf32 peak.  ``bound_simt_ms``: the fp32 SIMT figure
    of the earlier formula (c b^T per head, every term, 67 TFLOP/s)."""
    xh, Bm = c["xh"], c["B"]
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = ref.ssd_chunk_len(T, c["chunk"])
    nc = T // Q
    with_h = nc if c["h0"] is not None else nc - 1      # chunks with a carried-in state
    ops = Bsz * (nc * (G * Q * (Q + 1) * N + H * (Q * (Q + 1) * P + 2 * Q * P * N))
                 + with_h * H * 2 * Q * P * N)
    es = xh.element_size()
    h0_bytes = 0 if c["h0"] is None else 4 * c["h0"].numel()
    nbytes = (xh.numel() * es + 2 * Bm.numel() * es + 4 * c["dt"].numel() + 4 * H + h0_bytes
              + 4 * xh.numel() + 4 * Bsz * H * P * N)
    t_bytes = nbytes / HBM_BYTES_PER_S
    if c["dtype"] == "float32":
        t_ops, label = 3 * ops / PEAK_OPS["tf32"], "operations (3xTF32)"
    else:
        t_ops, label = ops / PEAK_OPS["bfloat16"], "operations"
    simt_ops = Bsz * H * nc * (Q * (Q + 1) * (N + P) + 4 * Q * P * N)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else label,
            "bound_simt_ms": 1e3 * max(t_bytes, simt_ops / PEAK_OPS["float32"]),
            "ops": ops, "bytes": nbytes}


def run_ssd_case(torch, K6, ref, c):
    """K6 against the plain scan on the same inputs (the one-chunk contract
    through ``ssd_chunk_cuda`` and ``ssd_chunk_ref``), two calls bit for bit
    and the device kernels a call issues (all ``ssd_*``, as many as
    ``ssd_device_kernels`` says), with its time beside the plain version's
    and the bound; there is no library call for it."""
    Bsz, T, H, P = c["xh"].shape
    G, N = c["B"].shape[2], c["B"].shape[3]
    if c["contract"]:
        fold = lambda t: t.transpose(1, 2).reshape(Bsz * H, T, -1)  # noqa: E731
        rep = H // G
        x, b, cc = fold(c["xh"]), fold(c["B"].repeat_interleave(rep, 2)), \
            fold(c["C"].repeat_interleave(rep, 2))
        dt = c["dt"].transpose(1, 2).reshape(Bsz * H, T).contiguous()
        l = (-dt * c["A"].repeat(Bsz)[:, None]).contiguous()
        h0 = c["h0"].reshape(Bsz * H, P, -1)
        args = (x.contiguous(), b.contiguous(), cc.contiguous(), dt, l, h0)
        kernel, plain = K6.ssd_chunk_cuda, ref.ssd_chunk_ref
        plan = K6.ssd_plan(Bsz * H, T, 1, 1, P, N, T, torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    else:
        args = (c["xh"], c["B"], c["C"], c["dt"], c["A"], c["h0"])
        kernel = lambda *a: K6.ssd_chunked_cuda(*a, c["chunk"])  # noqa: E731

        def plain(xh, B_, C_, dt, A, h0):
            if h0 is None:
                h0 = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
            return ref.ssd_chunked_ref(xh, B_, C_, dt, A, h0, c["chunk"])
        Q = ref.ssd_chunk_len(T, c["chunk"])
        plan = K6.ssd_plan(Bsz, T, H, G, P, N, Q,
                           torch.cuda.get_device_properties(0).multi_processor_count)
    y, h = kernel(*args)
    y2, h2 = kernel(*args)
    torch.cuda.synchronize()
    wy, wh = plain(*args)
    tol = SSD_TOL[c["dtype"]]
    ey, oky = within(torch, y, wy, tol)
    eh, okh = within(torch, h, wh, tol)
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    bitwise = bool(torch.equal(y, y2)) and bool(torch.equal(h, h2))
    names = [kernel_name(n) for n in device_kernels(torch, kernel, args)]
    kernels_ok = (len(names) == plan["device_kernels"]
                  and all(n.startswith("ssd_") for n in names))
    row = dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=max(ey, eh),
               y_max_abs_err=ey, h_max_abs_err=eh, tol=tol, finite=finite,
               bitwise_repeatable=bitwise, plan={k: plan[k] for k in (
                   "wr", "nspl", "heads_per_block", "out_blocks", "state_blocks")},
               device_kernels=len(names), kernel_names=names,
               ok=oky and okh and finite and bitwise and kernels_ok)
    case_bytes = sum(t.numel() * t.element_size() for t in args if t is not None) \
        + 4 * y.numel()
    copies = min(16, max(2, math.ceil(2 * 50e6 / case_bytes)))
    sets = [tuple(None if t is None else t.clone() for t in args) for _ in range(copies)]
    row["ms"] = device_ms(torch, kernel, sets)
    row["plain_ms"] = device_ms(torch, plain, sets, iters=5)
    row["library_ms"] = None
    b = ssd_bound(torch, ref, c)
    row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"], bound_simt_ms=b["bound_simt_ms"])
    del sets
    return row


SSD_CASES = [   # mamba2-1.3b's heads: H 64, P 64, N 128, one group, chunk 256
    ("prefill_b4_t2048_ragged", dict(B=4, T=2048, lens=[2048, 1500, 777, 64])),
    ("contract_q256_h0", dict(B=1, T=256, h0=True, contract=True)),
    ("t300_q150", dict(B=2, T=300, lens=[300, 211])),
    ("t257_q1", dict(B=2, T=257, lens=[257, 100])),
    ("serve_b8_t16", dict(B=8, T=16, lens=[15, 12, 9, 15, 7, 10, 13, 11])),
    ("serve_b1_t64", dict(B=1, T=64, lens=[59])),
    ("serve_b1_t128", dict(B=1, T=128, lens=[101])),
    ("serve_b1_t256", dict(B=1, T=256, lens=[213])),
    ("strong_decay_t512", dict(B=2, T=512, strong=True, h0=True)),
    ("smoke_widths_t24", dict(B=2, T=24, H=8, P=32, N=16, chunk=8, h0=True)),
    ("serve_b1_t256_g8", dict(B=1, T=256, G=8, lens=[213])),   # 8 heads a group
]


def phase_ssd_kernels(torch, K6, ref):
    rows = []
    for i, (name, kw) in enumerate(SSD_CASES):
        for dtype in ("float32", "bfloat16"):
            c = make_ssd_case(torch, f"ssd_{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                              dtype=dtype, seed=400 + i, **kw)
            r = run_ssd_case(torch, K6, ref, c)
            rows.append(r)
            print("  " + json.dumps(r), flush=True)
            del c
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, "K6 disagrees with its plain version, is not finite, differs between two "
          f"calls or issues other device kernels than its rule: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 3: full width, 2 layers, fp32: card against CPU


def greedy_logits(torch, model, params, tokens, lens, steps, cache_len, device):
    """Prefill, then ``steps`` one-token decode steps feeding the argmax,
    each committed (a Mamba-2 cache takes its checkpoint)."""
    cache = model.init_cache(tokens.shape[0], cache_len, torch.float32, device)
    toks = tokens.to(device)
    logits, cache, seq = model.prefill(params, toks, cache, lens.to(device))
    out_l, out_t = [logits.cpu()], []
    nxt = torch.argmax(logits, -1)
    seq = seq + 1
    for _ in range(steps):
        out_t.append(nxt.cpu())
        logits, out = model.decode_step(params, nxt[:, None].to(torch.int32), cache, seq)
        cache = model.commit(out, torch.zeros_like(seq))   # the ring's is a no-op
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


def profile_step(torch, eng, tp, dp, name, state, s, steps=4, keep=None):
    """One engine step at length ``s`` from ``state``: the wall time of an
    unprofiled run of ``steps`` steps against the device time that
    ``torch.profiler`` sees over as many more, with the kernels' shares and
    the host's most expensive ops.  The state after the steps is appended
    to ``keep`` when given."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        """Device activity (kernels, copies) by name, in ms per step."""
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
        return by

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
        paged_device_kernels=sum(1 for e in prof.events()
                                 if e.device_type == torch.autograd.DeviceType.CUDA
                                 and "paged_verify_kernel" in e.name) / steps,
        k5_ms=sum(t for k, t in dev.items() if "rmsnorm" in k),
        k5_launches=sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "rmsnorm" in e.name) / steps,
        device_kernels=sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / steps,
        top_device_ms={k[:60]: t for k, t in top_dev},
        top_host_ms={e.key[:60]: e.self_cpu_time_total / 1e3 / steps
                     for e in top_cpu})
    print("  " + json.dumps({"step": name, "s": s, **row}), flush=True)
    if keep is not None:
        keep.append(state)
    return row


def profile_mixed(torch, np, eng, tp, dp, state, vocab, steps=3, slot=15, plen=480, chunk=64):
    """Slot ``slot`` of a paged state takes a ``plen``-token prompt in
    ``chunk``-token chunks while the other slots decode at s = 0: each
    iteration defers one chunk (``prefill_chunk_into(..., defer=True)``:
    its host bookkeeping, untimed), then runs its forward inside the step
    (``step_with_chunk``, the mixed launch) or on its own before it
    (``flush_chunk``, then ``step``).  The wall time of that part (the
    step ends in its ``.cpu()`` read of the counts) over ``steps``
    iterations, against the device time ``torch.profiler`` sees over as
    many more; K3's device time and device kernels a step."""
    from torch.profiler import ProfilerActivity, profile
    prompt = np.random.default_rng(41).integers(0, vocab, plen).astype(np.int32)
    out = {}
    for name in ("mixed", "flush_then_step"):
        state = eng.retire_slot(state, slot)
        cur = 0

        def one():
            nonlocal state, cur
            state, ch = eng.prefill_chunk_into(tp, dp, state, slot, prompt[cur:cur + chunk],
                                               cur, chunk, plen, defer=True)
            cur += chunk
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "mixed":
                state, _ = eng.step_with_chunk(tp, dp, state, 0, ch)
            else:
                state = eng.flush_chunk(tp, dp, state, ch)
                state, _ = eng.step(tp, dp, state, 0)
            return time.perf_counter() - t0
        one()
        wall_ms = 1e3 * sum(one() for _ in range(steps)) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                one()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in dev) / 1e3 / steps
        k3 = [e for e in dev if "paged_verify_kernel" in e.name]
        row = dict(wall_ms=wall_ms, device_busy_ms=busy,
                   idle_share=max(0.0, 1.0 - busy / wall_ms), device_kernels=len(dev) / steps,
                   k3_ms=sum(e.device_time_total for e in k3) / 1e3 / steps,
                   k3_device_kernels=len(k3) / steps)
        print("  " + json.dumps({"step": f"paged_b16_s0_chunk{chunk}_{name}", **row}),
              flush=True)
        out[name] = row
    eng.retire_slot(state, slot)
    return out


def profile_prefill(torch, np, model, params, vocab, T=256, n=213, calls=3):
    """One target prefill at B = 1 of a prompt of ``n`` tokens padded to
    ``T`` (the continuous run's largest bucket), bf16: its wall time against
    the device time ``torch.profiler`` sees, and K6's share of it."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.from_numpy(np.random.default_rng(37).integers(0, vocab, (1, T))
                            .astype(np.int64)).cuda()
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")

    def run():
        cache = model.init_cache(1, T, torch.bfloat16, "cuda")
        return model.prefill(params, toks, cache, lens)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3 / calls
    k6 = sum(e.device_time_total for e in dev
             if kernel_name(e.name).startswith("ssd_")) / 1e3 / calls
    k6_kernels = sum(1 for e in dev if kernel_name(e.name).startswith("ssd_")) / calls
    row = dict(prefill=f"B1 T{T} prompt {n}, bf16", wall_ms=wall_ms, device_busy_ms=busy,
               k6_ms=k6, k6_share=k6 / busy if busy else None, k6_device_kernels=k6_kernels,
               device_kernels=len(dev) / calls)
    print("  " + json.dumps(row), flush=True)
    return row


def phase_profile(torch, np, R, SpecDecodeEngine):
    """Full-width pair, bf16: the wall time of one engine step at B = 8,
    s = 0 and s = 3 on the ring cache, and at B = 16, s = 0 on a paged pool
    of 16 x 8 blocks, against the device time that ``torch.profiler`` sees,
    with the verify kernels' share and the host's most expensive ops; then
    on that pool one mixed verify+chunk step (a 64-token chunk of slot 15
    inside the step of slots 0-14) against the chunk on its own then the
    step (``profile_mixed``)."""
    bf16 = torch.bfloat16
    eng = SpecDecodeEngine(R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b"),
                           max_new=64, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, eng.tcfg.vocab_size, (8, 16)).astype(np.int32)
    lens = np.full((8,), 16, np.int32)
    out = {}
    for s in (0, 3):
        out[f"ring_b8_s{s}"] = profile_step(torch, eng, tp, dp, f"ring_b8_s{s}",
                                            eng.prefill(tp, dp, toks, lens, 256), s)
    state = eng.init_slots(16, 512, block_size=16, num_blocks=192)
    ptoks = rng.integers(0, eng.tcfg.vocab_size, (16, 128)).astype(np.int32)
    for slot in range(16):
        state = eng.prefill_into(tp, dp, state, slot, ptoks[slot], 128, 512)
    keep = []
    out["paged_b16_s0"] = profile_step(torch, eng, tp, dp, "paged_b16_s0", state, 0,
                                       keep=keep)
    check(all(v["device_busy_ms"] > 0 for v in out.values()),
          "the profiler saw no device time")
    check(out["paged_b16_s0"]["paged_kernel_ms"] > 0,
          "the profiler saw no paged kernel in the paged step")
    mixed = profile_mixed(torch, np, eng, tp, dp, keep[0], eng.tcfg.vocab_size)
    check(all(v["device_busy_ms"] > 0 and v["k3_ms"] > 0 for v in mixed.values()),
          f"the profiler saw no device time or no K3 in a chunked step: {mixed}")
    out.update({f"paged_b16_s0_chunk64_{k}": v for k, v in mixed.items()})
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
    """The scheduling decisions of a StepTrace, chunk events included,
    without its clock."""
    return [(t.occupancy, t.s, t.rids, t.committed, t.admitted, t.preempted, t.done_rids,
             t.chunked) for t in trace]


def replays_equal(np, m, res, reqs, controller, policy, capacity, **geo):
    """Whether ``SimStepBackend`` replaying ``res``'s recorded outcomes (with
    the live pool's block geometry ``geo``) re-derives its StepTrace."""
    import copy
    acc, dur, pre, done, chunk = m.replay_sources(res.trace)
    bs = (1, 2, 4, 8, 16)
    model = m.LatencyModel(alpha={b: 1e-4 for b in bs}, beta={b: 5e-3 for b in bs},
                           t_s={b: 2e-4 for b in bs}, c=0.9, gamma=0.548)
    sim = m.ContinuousScheduler(
        m.SimStepBackend(model, capacity=capacity, accept_source=acc, duration_source=dur,
                         prefill_source=pre, done_source=done, chunk_source=chunk, **geo),
        controller, policy)
    sim.run(copy.deepcopy(reqs))
    return trace_signature(sim.trace) == trace_signature(res.trace)


def chunk_counts(res):
    """Chunk events of a run: per request, and the largest per iteration."""
    per_rid = {}
    for t in res.trace:
        for rid, _ in t.chunked:
            per_rid[rid] = per_rid.get(rid, 0) + 1
    return dict(chunk_events=sum(per_rid.values()),
                max_chunks_per_prompt=max(per_rid.values(), default=0),
                max_chunk_tokens_per_iteration=max(
                    (sum(n for _, n in t.chunked) for t in res.trace), default=0))


def engine_calls(eng):
    """Count, and time on the host clock, the engine's mixed steps, plain
    steps, flushes and chunk forwards run at feed time, by wrapping its
    methods on the instance (``release_calls`` takes them off).  A step ends
    in its ``.cpu()`` read of the counts, so its host time covers its
    device work."""
    rec = {"step_with_chunk": [], "step": [], "flush_chunk": [], "final_chunks": 0,
           "deferred_chunks": 0}
    for name in ("step_with_chunk", "step", "flush_chunk", "prefill_chunk_into"):
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            if kw.get("warm"):
                return _fn(*a, **kw)
            if _name == "prefill_chunk_into":
                rec["deferred_chunks" if kw.get("defer") else "final_chunks"] += 1
                return _fn(*a, **kw)
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            rec[_name].append(time.perf_counter() - t0)
            return out
        setattr(eng, name, wrapped)
    return rec


def release_calls(eng):
    for name in ("step_with_chunk", "step", "flush_chunk", "prefill_chunk_into"):
        eng.__dict__.pop(name, None)


def phase_continuous_parity(torch, np, R, m):
    """fp32, the full-width pair cut to 2 layers: the paged live run, the
    contiguous live run, both again with chunked prefill
    (``PrefillBudgetAdmit(16, chunk=8)``), the paged chunked run again with
    the mixed verify+chunk launch, and solo generate give the same tokens;
    the paged runs preempt; the mixed run's StepTrace equals the chunked
    run's but for its durations, and at least one chunk rode a step; every
    StepTrace replays on the sim backend (the arrivals are all 0, so the
    schedules do not hang on the wall clock); and the model's paged
    decode_step gives the same logits through K2 and K3."""
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
    budget = dict(token_budget=16, chunk=8)
    runs, calls = {}, None
    for name, kw, chunked in (("paged", paged_geo, False), ("contiguous", {}, False),
                              ("paged_chunked", paged_geo, True),
                              ("contiguous_chunked", {}, True),
                              ("paged_mixed", dict(paged_geo, mixed_launch=True), True)):
        be = m.ContinuousEngineBackend(eng, tp, dp, collect_outputs=True, warm_s=(3,),
                                       **geo, **kw)
        pol = m.PrefillBudgetAdmit(**budget) if chunked else None
        if name == "paged_mixed":
            calls = engine_calls(eng)
        try:
            runs[name] = (m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp, ctrl,
                                                  backend=be, policy=pol), be)
        finally:
            release_calls(eng)
    res, be = runs["paged"]
    mismatched = []
    for r in reqs:
        solo, _, _ = eng.generate(tp, dp, r.tokens[None], np.array([r.prompt_len], np.int32),
                                  s=3, cache_len=96)
        if not all(np.array_equal(runs[k][1].outputs[r.rid], solo[0][:r.max_new])
                   for k in runs):
            mismatched.append(r.rid)
    n_pre = {k: sum(len(t.preempted) for t in runs[k][0].trace) for k in runs}
    replay_equal = {
        k: replays_equal(np, m, runs[k][0], reqs, ctrl,
                         m.PrefillBudgetAdmit(**budget) if k != "paged" else None,
                         8, max_context=96, **(paged_geo if k.startswith("paged") else {}))
        for k in runs if k != "contiguous"}
    chunks = {k: chunk_counts(runs[k][0]) for k in ("paged_chunked", "contiguous_chunked")}
    mixed_trace_equal = (trace_signature(runs["paged_mixed"][0].trace)
                         == trace_signature(runs["paged_chunked"][0].trace))
    mixed_calls = {k: len(calls[k]) for k in ("step_with_chunk", "step", "flush_chunk")}
    mixed_calls.update(final_chunks=calls["final_chunks"],
                       deferred_chunks=calls["deferred_chunks"])

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
    line = dict(requests=len(reqs), tokens_equal_whole_chunked_solo=not mismatched,
                mismatched_rids=mismatched, preemptions=n_pre,
                steps={k: len(runs[k][0].trace) for k in runs}, chunks=chunks,
                sim_replay_equal=replay_equal, mixed_trace_equals_chunked=mixed_trace_equal,
                mixed_calls=mixed_calls,
                model_decode_k2_equals_k3=model_equal, k2_launches=dense_launches)
    print("  " + json.dumps(line), flush=True)
    check(not mismatched, f"paged / contiguous (whole, chunked or mixed) / solo tokens differ "
                          f"for rids {mismatched}")
    check(n_pre["paged"] > 0, "the undersized pool never preempted")
    check(n_pre["paged_mixed"] > 0, "the mixed run never preempted")
    check(mixed_trace_equal, "the mixed run's StepTrace differs from the chunked run's")
    check(mixed_calls["step_with_chunk"] > 0, "no chunk rode a step in the mixed run")
    check(all(replay_equal.values()),
          f"a StepTrace differs from its SimStepBackend replay: {replay_equal}")
    check(all(c["max_chunks_per_prompt"] >= 3 for c in chunks.values()),
          f"no prompt spanned 3 chunks: {chunks}")
    check(all(c["max_chunk_tokens_per_iteration"] <= budget["token_budget"]
              for c in chunks.values()), f"an iteration's chunks exceed the budget: {chunks}")
    check(model_equal, "the paged decode_step differs between K2 and K3")
    check(dense_launches > 0, "the paged decode_step without cu_blocks never launched K2")
    return line


def serve_line(m, res, wall):
    """End-to-end numbers of one serve_continuous_live run, with the mean
    host seconds of a step, a whole-prompt prefill and a chunk."""
    busy = sum(b.duration for b in res.batches)
    prefills = [dt for t in res.trace for dt in t.prefill_s if dt >= 0]   # -1: chunked
    chunks = [dt for t in res.trace for dt in t.chunk_s]
    return dict(
        wall_s=wall, ttft=dataclasses.asdict(m.ttft_summary(res)),
        itl=dataclasses.asdict(m.itl_summary(res)),
        tokens_per_s=sum(r.n_generated for r in res.requests) / busy,
        goodput=m.goodput(res), steps=len(res.batches), mean_occupancy=m.mean_occupancy(res),
        s_used=sorted({b.s_used for b in res.batches}),
        preemptions=sum(len(t.preempted) for t in res.trace),
        step_s_mean=busy / max(len(res.batches), 1),
        prefill_s_mean=sum(prefills) / max(len(prefills), 1), prefills=len(prefills),
        chunk_s_mean=sum(chunks) / max(len(chunks), 1))


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
    for c in (m.K1.KERNEL, m.K23.DENSE, m.K23.RAGGED, m.K5.FWD, m.ops.PLAIN, m.paged.PLAIN,
              m.ops.PLAIN_RMSNORM):
        c.launches = 0
    t0 = time.perf_counter()
    res = m.serve_continuous_live(reqs, eng, tp, dp, ctrl, capacity=16, cache_len=512,
                                  block_size=16, num_blocks=144)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k1=m.K1.KERNEL.launches, k2=m.K23.DENSE.launches,
                    k3=m.K23.RAGGED.launches, k5=m.K5.FWD.launches,
                    plain=(m.ops.PLAIN.launches + m.paged.PLAIN.launches
                           + m.ops.PLAIN_RMSNORM.launches))
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    line = dict(
        requests=len(reqs), finished=len(done), **serve_line(m, res, wall),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        grid_steps_ragged=grid["ragged"], grid_steps_dense=grid["dense"],
        launches=launches)
    print("  " + json.dumps(line), flush=True)
    check(len(done) == len(reqs), f"{len(reqs) - len(done)} requests did not finish")
    check(line["preemptions"] > 0, "the paged pool never ran short: no request was preempted")
    check(launches["k3"] > 0, "the paged serving path never launched K3")
    check(launches["k1"] > 0, "the paged serving path never launched K1")
    check(launches["k5"] > 0, "the paged serving path never launched K5")
    check(launches["plain"] == 0, "a plain version ran on the card")
    return line


def chunked_rows_check(torch, np, m, eng, tp, dp, vocab, plen=448, chunk=64):
    """One ``plen``-token prompt fed in ``chunk``-token chunks into a paged
    pool (the target's chunks on K3, the draft's on K1) against the same
    prompt by ``prefill_into`` (K1 over a ring, then copied into blocks),
    both in bf16, with the whole route in fp32 (the bf16 weights cast) as
    the reference; and the same chunks fed through mixed steps (slot 15 of
    16: each non-final chunk deferred and run inside a step of slots 0-14
    decoding at s = 0, K3 carrying both kinds of rows; the final chunk on
    its own).  Gated for the chunked route: positions equal; layer 0's K/V
    rows equal (no attention before them); at every layer the rows, read
    through the slot's table, no further from the fp32 rows than the whole
    route's, 1.5x in relative RMS (phase 7's rule for two bf16 routes),
    over the layer and in its worst row; the same for the first step's
    logits.  The mixed route is gated the same way but for layer 0, whose
    equality is reported: its products run on another number of rows.
    Reported: the elementwise 1e-2 (abs + rel) comparison with the whole
    route, and the greedy tokens."""
    rng = np.random.default_rng(29)
    prompt = rng.integers(0, vocab, plen).astype(np.int32)
    others = [rng.integers(0, vocab, int(n)).astype(np.int32)
              for n in rng.integers(64, 193, 15)]
    slot_of = {"whole": 0, "chunked": 0, "mixed": 15}

    def fill(e, tparams, dparams, route):
        if route == "whole":
            st = e.init_slots(1, 512, block_size=16)
            toks = np.ones((512,), np.int32)
            toks[:plen] = prompt
            return e.prefill_into(tparams, dparams, st, 0, toks, plen, 512)
        st = e.init_slots(len(others) + 1 if route == "mixed" else 1, 512, block_size=16,
                          num_blocks=320 if route == "mixed" else None)
        if route == "mixed":
            for slot, p in enumerate(others):
                st = e.prefill_into(tparams, dparams, st, slot, p, len(p), 512)
        slot, cur = slot_of[route], 0
        while cur < plen - 1:
            n = min(chunk, plen - 1 - cur)
            toks = np.ones((chunk,), np.int32)
            toks[:n] = prompt[cur:cur + n]
            final = cur + n == plen - 1
            if route == "mixed" and not final:
                st, ch = e.prefill_chunk_into(tparams, dparams, st, slot, toks, cur, n, plen,
                                              defer=True)
                st, _ = e.step_with_chunk(tparams, dparams, st, 0, ch)
            else:
                st = e.prefill_chunk_into(tparams, dparams, st, slot, toks, cur, n, plen,
                                          last2=prompt[-2:] if final else None)
            cur += n
        return st

    def rows(st, slot):
        """K, V and pos of the prefilled rows through the slot's table, and
        the draft ring's K and V, in fp32."""
        ids = torch.tensor(st.paged.table(slot), device="cuda")
        out = {n: st.tcache[n][:, ids].flatten(1, 2)[:, :plen - 1].float() for n in ("k", "v")}
        out.update({"draft_" + n: st.dcache[n][:, slot, :plen - 2].float() for n in ("k", "v")})
        return out, st.tcache["pos"][ids].flatten()[:plen - 1]

    def first_logits(e, tparams, st, slot):
        """The target's logits of the first decode step (s = 0: the last
        prompt token at position plen - 1), through K3 as the step runs it."""
        cu = torch.from_numpy(m.host_cu_blocks(st.paged.device_tables())).cuda()
        lg, _ = e.target.decode_step(tparams, st.last2[:, 1:], st.tcache, st.seq_lens, cu)
        return lg[slot, -1, :vocab].float()

    def rel_rms(x, want, dims):
        return ((x - want) ** 2).mean(dims).sqrt() / (want ** 2).mean(dims).sqrt()

    states = {r: fill(eng, tp, dp, r) for r in slot_of}
    got = {r: rows(st, slot_of[r]) for r, st in states.items()}
    lg = {r: first_logits(eng, tp, st, slot_of[r]) for r, st in states.items()}
    e32 = m.SpecDecodeEngine(eng.tcfg, eng.dcfg, max_new=eng.max_new, dtype=torch.float32,
                             device="cuda")
    tp32, dp32 = (tree_map(lambda t: t.float(), p) for p in (tp, dp))
    ref = fill(e32, tp32, dp32, "whole")
    rf, _ = rows(ref, 0)
    lf = first_logits(e32, tp32, ref, 0)
    del e32, tp32, dp32, ref
    torch.cuda.empty_cache()
    ratio = BF16_GRAD_RMS_RATIO
    tol = TOL["bfloat16"]
    (rw, pw), lw = got["whole"], lg["whole"]
    line = dict(prompt=plen, chunk=chunk)
    tokens = {}
    for route, st in states.items():
        slot = slot_of[route]
        for _ in range(eng.max_new + 2):
            st, _ = eng.step(tp, dp, st, 0)
            if bool(st.done[slot].cpu()):
                break
        tokens[route] = st.out[slot, :eng.max_new].cpu().numpy()
    for route in ("chunked", "mixed"):
        (rc, pc), lc = got[route], lg[route]
        ok = bool(torch.equal(pc, pw))
        stats = {}
        for name in rw:
            w, c, f = rw[name], rc[name], rf[name]
            layer_w, layer_c = rel_rms(w, f, (1, 2, 3)), rel_rms(c, f, (1, 2, 3))
            row_w, row_c = (rel_rms(x, f, (2, 3)).max(1).values for x in (w, c))
            err = (c - w).abs()
            beyond = (err > tol + tol * w.abs()).flatten(1).float().mean(1)
            layer0 = bool(torch.equal(c[0], w[0]))
            ok &= (layer0 or route == "mixed") and bool((layer_c <= ratio * layer_w).all()) \
                and bool((row_c <= ratio * row_w).all())
            stats[name] = dict(layer0_equal=layer0,
                               rel_rms_vs_fp32_deepest=[float(layer_w[-1]), float(layer_c[-1])],
                               worst_layer_ratio=float((layer_c / layer_w).max()),
                               worst_row_ratio=float((row_c / row_w).max()),
                               max_abs_err_vs_whole=float(err.max()),
                               beyond_1e2_share_deepest=float(beyond[-1]),
                               beyond_1e2_share_layer1=float(beyond[min(1, len(beyond) - 1)]))
        logits_ok = bool(rel_rms(lc, lf, 0) <= ratio * rel_rms(lw, lf, 0))
        lerr = (lc - lw).abs()
        same = tokens["whole"] == tokens[route]
        line[route] = dict(
            rows_ok=ok, positions_equal=bool(torch.equal(pc, pw)), rows=stats,
            logits_ok=logits_ok,
            logits_rel_rms_vs_fp32=[float(rel_rms(lw, lf, 0)), float(rel_rms(lc, lf, 0))],
            logits_max_abs_err_vs_whole=float(lerr.max()),
            logits_beyond_1e2_share=float((lerr > tol + tol * lw.abs()).float().mean()),
            first_token_equal=bool(lw.argmax() == lc.argmax()),
            greedy_tokens_equal=int(same.sum()), greedy_tokens=int(same.size),
            first_divergence=None if same.all() else int(np.argmin(same)))
    print("  chunked and mixed vs whole prefill (bf16): " + json.dumps(line), flush=True)
    for route in ("chunked", "mixed"):
        check(line[route]["rows_ok"], f"{route} prefill's rows differ from the whole route's "
                                      f"beyond its own bf16 error: {line[route]['rows']}")
        check(line[route]["logits_ok"], f"the first step's logits after a {route} prefill are "
                                        f"further from fp32 than {ratio}x the whole route's")
    return line


def phase_chunked_serve(torch, np, R, m, lut_table):
    """bf16, full depth: serve_continuous_live with chunked prefill
    (``PrefillBudgetAdmit(128, chunk=64)``) on phase 6b's pair and paged
    pool, 24 requests of 64-448 prompt tokens; every request finishes,
    prompts span >= 3 chunks, no iteration's chunks exceed the budget, the
    StepTrace replays on the sim backend, K3 runs once per layer in every
    step and every chunk forward and no plain version runs; the same trace
    with whole-prompt admission beside it; the same trace with the mixed
    verify+chunk launch (``mixed_launch=True``): every request finishes,
    the StepTrace replays, chunks ride steps, K3 runs once per layer in
    every step and every chunk forward run on its own (the final chunks and
    the flushed ones) and no plain version runs; then a 448-token prompt
    chunked, and fed through mixed steps, against ``prefill_into``
    (``chunked_rows_check``)."""
    import copy
    bf16 = torch.bfloat16
    tcfg, dcfg = R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b")
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    lut = {int(b): int(v) for b, v in lut_table.items()}
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 24, (64, 448), 32, 0.05, 31)
    budget = dict(token_budget=128, chunk=64)
    geo = dict(capacity=16, cache_len=512, block_size=16, num_blocks=144)
    eng.load_kernels(paged=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (m.K1.KERNEL, m.K23.DENSE, m.K23.RAGGED, m.K5.FWD, m.ops.PLAIN, m.paged.PLAIN,
                m.ops.PLAIN_RMSNORM)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp,
                                  m.AdaptiveController(lut=m.SpeculationLUT(lut)),
                                  policy=m.PrefillBudgetAdmit(**budget), **geo)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k1=m.K1.KERNEL.launches, k2=m.K23.DENSE.launches,
                    k3=m.K23.RAGGED.launches, k5=m.K5.FWD.launches,
                    plain=(m.ops.PLAIN.launches + m.paged.PLAIN.launches
                           + m.ops.PLAIN_RMSNORM.launches))
    peak = torch.cuda.max_memory_allocated() / 1e9
    chunks = chunk_counts(res)
    # K3 carries the target's attention in every step's verify and in every
    # chunk forward on the paged pool, once per layer; nothing else calls it
    k3_expected = tcfg.n_layers * (len(res.batches) + chunks["chunk_events"])
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    replay = replays_equal(np, m, res, reqs, m.AdaptiveController(lut=m.SpeculationLUT(lut)),
                           m.PrefillBudgetAdmit(**budget), 16, max_context=512,
                           block_size=16, num_blocks=144)
    t0 = time.perf_counter()
    whole = m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp,
                                    m.AdaptiveController(lut=m.SpeculationLUT(lut)), **geo)
    torch.cuda.synchronize()
    whole_line = serve_line(m, whole, time.perf_counter() - t0)
    mixed = mixed_serve(torch, np, m, eng, tp, dp, reqs, lut, budget, geo, counters)
    line = dict(requests=len(reqs), finished=len(done), **serve_line(m, res, wall),
                peak_memory_gb=peak, **chunks, sim_replay_equal=replay, launches=launches,
                k3_expected=k3_expected, whole_prompt=whole_line, mixed_launch=mixed)
    print("  " + json.dumps(line), flush=True)
    check(len(done) == len(reqs), f"{len(reqs) - len(done)} requests did not finish")
    check(chunks["max_chunks_per_prompt"] >= 3, "no prompt spanned 3 chunks")
    check(chunks["max_chunk_tokens_per_iteration"] <= budget["token_budget"],
          "an iteration's chunk tokens exceed the budget")
    check(replay, "the chunked StepTrace differs from its SimStepBackend replay")
    check(launches["k3"] == k3_expected,
          f"K3 ran {launches['k3']} times, not 32 x (steps + chunks) = {k3_expected}")
    check(launches["k1"] > 0 and launches["k5"] > 0, "K1 or K5 never ran")
    check(launches["plain"] == 0, "a plain version ran on the card")
    check(mixed["finished"] == len(reqs),
          f"{len(reqs) - mixed['finished']} requests did not finish with the mixed launch")
    check(mixed["sim_replay_equal"], "the mixed StepTrace differs from its SimStepBackend replay")
    check(mixed["fused_steps"] > 0, "no chunk rode a step with the mixed launch")
    check(mixed["deferred_chunks"] == mixed["fused_steps"] + mixed["flushed_chunks"]
          and mixed["chunk_events"] == mixed["deferred_chunks"] + mixed["final_chunks"],
          f"the mixed run's chunks do not add up: {mixed}")
    check(mixed["launches"]["k3"] == mixed["k3_expected"],
          f"K3 ran {mixed['launches']['k3']} times with the mixed launch, not 32 x (steps + "
          f"final chunks + flushed chunks) = {mixed['k3_expected']}")
    check(mixed["launches"]["k1"] > 0 and mixed["launches"]["k5"] > 0,
          "K1 or K5 never ran with the mixed launch")
    check(mixed["launches"]["plain"] == 0, "a plain version ran on the card (mixed launch)")
    line["rows"] = chunked_rows_check(torch, np, m, eng, tp, dp, tcfg.vocab_size)
    return line


def mixed_serve(torch, np, m, eng, tp, dp, reqs, lut, budget, geo, counters):
    """Phase 6c's trace with ``mixed_launch=True``: its serving numbers, the
    launches, the engine's mixed steps, plain steps, flushes and final
    chunks (``engine_calls``), the mean host time of a mixed and of a plain
    step, and K3's expected launches: once per layer in every step and in
    every chunk forward run on its own."""
    import copy
    for c in counters:
        c.launches = 0
    calls = engine_calls(eng)
    t0 = time.perf_counter()
    try:
        res = m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp,
                                      m.AdaptiveController(lut=m.SpeculationLUT(lut)),
                                      policy=m.PrefillBudgetAdmit(**budget), mixed_launch=True,
                                      **geo)
        torch.cuda.synchronize()
    finally:
        release_calls(eng)
    wall = time.perf_counter() - t0
    launches = dict(k1=m.K1.KERNEL.launches, k2=m.K23.DENSE.launches,
                    k3=m.K23.RAGGED.launches, k5=m.K5.FWD.launches,
                    plain=(m.ops.PLAIN.launches + m.paged.PLAIN.launches
                           + m.ops.PLAIN_RMSNORM.launches))
    fused, plain, flushed = (len(calls[k]) for k in ("step_with_chunk", "step", "flush_chunk"))
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    replay = replays_equal(np, m, res, reqs, m.AdaptiveController(lut=m.SpeculationLUT(lut)),
                           m.PrefillBudgetAdmit(**budget), geo["capacity"],
                           max_context=geo["cache_len"], block_size=geo["block_size"],
                           num_blocks=geo["num_blocks"])
    return dict(
        finished=len(done), **serve_line(m, res, wall), **chunk_counts(res),
        sim_replay_equal=replay, launches=launches, fused_steps=fused, plain_steps=plain,
        flushed_chunks=flushed, final_chunks=calls["final_chunks"],
        deferred_chunks=calls["deferred_chunks"],
        k3_expected=eng.tcfg.n_layers * (len(res.batches) + calls["final_chunks"] + flushed),
        mixed_step_ms_mean=1e3 * sum(calls["step_with_chunk"]) / max(fused, 1),
        plain_step_ms_mean=1e3 * sum(calls["step"]) / max(plain, 1),
        flush_ms_mean=1e3 * sum(calls["flush_chunk"]) / max(flushed, 1))


# ---------------------------------------------------------------------------
# phase 7: the training path


def tree_map(fn, tree):
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def phase_distill(torch, np, R, m):
    """The OPT-125M draft, full width, fp32, distilled for 20 steps of
    ``make_distill_step`` against the OPT-6.7B target in bf16 (phase 4's
    weights: the same seed and draw order; the draft keeps its fp32 draws),
    the teacher's logits computed under ``torch.no_grad``, on the markov2
    stream ``benchmarks/common.py`` trains its pair on.  The KL must fall;
    the mean accepted run at s = 4 before and after is reported."""
    bf16, f32 = torch.bfloat16, torch.float32
    tcfg, dcfg = R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b")
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, f32, "cuda")
    dc = m.DataConfig(vocab_size=tcfg.vocab_size, batch=8, seq_len=128, kind="markov2",
                      alphabet=48, skew=0.9, seed=0)
    prompts = m.batch_at(dc, 1000)["tokens"][:, :32]
    lens = np.full((8,), 32, np.int32)

    def accepted():
        runs = m.measure_acceptance(eng, tp, tree_map(lambda t: t.to(bf16), dp), prompts, lens,
                                    s=4, gen_tokens=16, cache_len=256)
        return float(np.mean(runs))

    before = accepted()
    step = m.make_distill_step(eng.draft, dcfg, m.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                             total_steps=20))
    state = m.init_adamw(dp)
    kls, t_teacher, t_step = [], 0.0, 0.0
    counters = dict(k4_fwd=m.K4.FWD, k4_bwd=m.K4.BWD, k5_fwd=m.K5.FWD, k5_bwd=m.K5.BWD,
                    plain_flash=m.ops.PLAIN_FLASH, plain_rmsnorm=m.ops.PLAIN_RMSNORM)
    for c in counters.values():
        c.launches = 0
    for i in range(20):
        toks = torch.from_numpy(m.batch_at(dc, i)["tokens"]).cuda()
        t0 = time.perf_counter()
        with torch.no_grad():
            teacher, _ = eng.target.forward(tp, toks[:, :-1])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dp, state, met = step(dp, state, {"tokens": toks, "teacher_logits": teacher})
        kls.append(float(met["kl"].cpu()))
        t2 = time.perf_counter()
        if i:
            t_teacher += t1 - t0
            t_step += t2 - t1
        del teacher
    launches = {k: c.launches for k, c in counters.items()}
    after = accepted()
    line = dict(kl_first=kls[0], kl_last=kls[-1], kl=kls, launches=launches,
                teacher_forward_ms=1e3 * t_teacher / 19,
                distill_step_ms=1e3 * t_step / 19, mean_accepted_s4_before=before,
                mean_accepted_s4_after=after)
    print("  " + json.dumps(line), flush=True)
    check(all(math.isfinite(k) for k in kls), "the KL is not finite")
    check(kls[-1] < kls[0], f"the distillation KL did not fall: {kls[0]} -> {kls[-1]}")
    check(min(launches[k] for k in ("k4_fwd", "k4_bwd", "k5_fwd", "k5_bwd")) > 0
          and launches["plain_flash"] + launches["plain_rmsnorm"] == 0,
          f"the distillation did not run on K4 and K5 alone: {launches}")
    return line


def phase_train(torch, m):
    """The internlm2-1.8b trainer at full width and depth, fp32, batch 8,
    seq 128, 20 steps on the markov stream (``repro_torch.launch.train``'s
    defaults), every launch count zeroed before it and read after; then
    ``torch.profiler`` over two more steps for the device-busy share."""
    from torch.profiler import ProfilerActivity, profile
    counters = (m.K4.FWD, m.K4.BWD, m.K5.FWD, m.K5.BWD, m.ops.PLAIN_FLASH,
                m.ops.PLAIN_RMSNORM, m.ops.PLAIN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    res = m.train.main(["--arch", "internlm2-1.8b", "--device", "cuda", "--steps", "20"])
    torch.cuda.synchronize()
    launches = dict(k4_fwd=m.K4.FWD.launches, k4_bwd=m.K4.BWD.launches,
                    k5_fwd=m.K5.FWD.launches, k5_bwd=m.K5.BWD.launches,
                    plain=sum(c.launches for c in counters[4:]))
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["launches"] = launches

    cfg = m.R.get_config("internlm2-1.8b")
    model = m.DecoderLM(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1), torch.float32, "cuda")
    state = m.init_adamw(params)
    step = m.make_train_step(model, cfg, m.AdamWConfig(warmup_steps=2, total_steps=20))
    dc = m.DataConfig(vocab_size=cfg.vocab_size, batch=8, seq_len=128, seed=0)
    batches = [{"tokens": torch.from_numpy(m.batch_at(dc, i)["tokens"]).cuda()}
               for i in range(3)]
    params, state, _ = step(params, state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            params, state, met = step(params, state, b)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 2
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.device_time_total / 1e3 / 2
    busy = sum(by.values())
    res["profile"] = dict(
        wall_ms_profiled=wall_ms, device_busy_ms=busy, busy_share=busy / wall_ms,
        k4_ms=sum(t for k, t in by.items() if "flash_bwd" in k
                  or ("fwd_kernel" in k and "rmsnorm" not in k)),
        k5_ms=sum(t for k, t in by.items() if "rmsnorm" in k),
        device_kernels=sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 2,
        top_device_ms={k[:60]: t for k, t in sorted(by.items(), key=lambda kv: kv[1],
                                                     reverse=True)[:6]})
    del params, state, batches
    print("  " + json.dumps(res), flush=True)
    check(res["losses"][-1] < res["losses"][0], "the trainer's loss did not fall")
    check(all(launches[k] > 0 for k in ("k4_fwd", "k4_bwd", "k5_fwd", "k5_bwd")),
          f"the trainer did not launch every kernel of its path: {launches}")
    check(launches["plain"] == 0, "a plain version ran on the card")
    check(res["peak_memory_gb"] < 80, "the trainer does not fit one 80 GB card")
    check(res["profile"]["device_busy_ms"] > 0, "the profiler saw no device time")
    return res


def phase_train_parity(torch, np, m, tree_to):
    """One fp32 train step of internlm2-1.8b cut to 2 layers (widths kept),
    B 2, T 64, on the card (K4, K5) and on the CPU (plain versions): the
    loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
    largest entry, and the step's grad norm within 1e-5 relative."""
    cfg = m.R.get_config("internlm2-1.8b").with_(n_layers=2)
    model = m.DecoderLM(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(5), torch.float32, "cpu")
    p_gpu = tree_to(p_cpu, "cuda")
    dc = m.DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=64, seed=3)
    toks = torch.from_numpy(m.batch_at(dc, 0)["tokens"])
    loss_fn = m.make_loss_fn(model, cfg)
    met_g, gr_g = m.value_and_grad(loss_fn, p_gpu, {"tokens": toks.cuda()})
    met_c, gr_c = m.value_and_grad(loss_fn, p_cpu, {"tokens": toks})
    loss_g, loss_c = float(met_g["loss"].cpu()), float(met_c["loss"])

    # each gradient's largest difference, relative to its tensor's largest entry
    def items(tree, prefix=""):
        for k, v in tree.items():
            yield from items(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]
    cpu = dict(items(gr_c))
    rel = {k: float((g.cpu() - cpu[k]).abs().max() / cpu[k].abs().max())
           for k, g in items(gr_g)}
    worst_name = max(rel, key=rel.get)
    worst = rel[worst_name]

    opt = m.AdamWConfig(warmup_steps=1, total_steps=10)
    _, _, gn_g = m.adamw_update(opt, gr_g, m.init_adamw(p_gpu), p_gpu)
    _, _, gn_c = m.adamw_update(opt, gr_c, m.init_adamw(p_cpu), p_cpu)
    line = dict(loss_card=loss_g, loss_cpu=loss_c, loss_rel_err=abs(loss_g - loss_c) / loss_c,
                worst_grad_rel_err=worst, worst_grad=worst_name,
                grad_norm_card=float(gn_g.cpu()), grad_norm_cpu=float(gn_c))
    print("  " + json.dumps(line), flush=True)
    check(line["loss_rel_err"] <= 1e-5, f"card vs CPU loss differs: {line}")
    check(worst <= 1e-4, f"card vs CPU gradient {worst_name} differs by {worst} of its max")
    check(abs(line["grad_norm_card"] - line["grad_norm_cpu"]) <= 1e-5 * line["grad_norm_cpu"],
          "card vs CPU grad norm differs")
    return line


def phase_prefill_flash(torch, np, R, m):
    """``prefill_flash`` (attention by K4 over the prompt) against
    ``prefill`` (K1 over the ring) on the full-width OPT-6.7B with phase 4's
    bf16-initialised weights: B 4, prompts of 512, 400, 301 and 77 tokens
    padded to 512, a 512-row ring.

    K4's forward sums on the tensor cores in another order than K1, so the
    two paths differ by rounding, which 32 bf16 layers carry past one bf16
    ulp of the logits.  The check is therefore made in two runs:

    (a) fp32, the same weights cast to fp32: last-token logits within 2e-3
        absolute plus relative, every written K/V row of every layer within
        1e-4 of its tensor's largest entry, layer 0's rows (before any
        attention), ``pos`` and ``seq_lens`` equal, K4 launched once per
        layer;
    (b) bf16, as served: ``prefill_flash``'s logits no further from (a)'s
        fp32 ``prefill`` logits, in relative RMS, than 1.5x ``prefill``'s
        own bf16 logits are."""
    bf16, f32 = torch.bfloat16, torch.float32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    model = m.DecoderLM(R.get_config("opt-6.7b"))
    n_layers = model.cfg.n_layers
    params = model.init(torch.Generator(device="cuda").manual_seed(0), bf16, "cuda")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (4, 512))).cuda()
    lens = torch.tensor([512, 400, 301, 77], dtype=torch.int32, device="cuda")

    V = model.cfg.vocab_size    # the padded vocabulary's logits are -1e30 on both paths

    def run(dtype):
        with torch.no_grad():
            m.K4.FWD.launches = 0
            lf, cf, sf = model.prefill_flash(params, toks,
                                             model.init_cache(4, 512, dtype, "cuda"), lens)
            k4 = m.K4.FWD.launches
            lp, cp, sp = model.prefill(params, toks, model.init_cache(4, 512, dtype, "cuda"),
                                       lens)
        torch.cuda.synchronize()
        return lf[:, :V].float(), cf, sf, lp[:, :V].float(), cp, sp, k4

    lf_b, _, _, lp_b, _, _, k4_b = run(bf16)

    def cast(tree):       # leaf by leaf, so that the two copies never coexist whole
        for k, v in tree.items():
            if isinstance(v, dict):
                cast(v)
            else:
                tree[k] = v.to(f32)
    cast(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lf, cf, sf, lp, cp, sp, k4 = run(f32)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params

    tol = 2e-3
    err = (lf - lp).abs()
    written = cp["pos"] >= 0
    kv_rel = max(float((cf[k][i][written] - cp[k][i][written]).abs().max()
                       / cp[k][i][written].abs().max())
                 for k in ("k", "v") for i in range(n_layers))
    layer0 = all(bool(torch.equal(cf[k][0][written], cp[k][0][written])) for k in ("k", "v"))

    check(bool(torch.isfinite(lp).all() and torch.isfinite(lf_b).all()
               and torch.isfinite(lp_b).all()), "prefill logits are not finite")
    line = dict(held_before_gb=held, fp32_peak_memory_gb=peak,
                fp32_logits_max_abs_err=float(err.max()), tol=tol, fp32_kv_max_rel_err=kv_rel,
                fp32_layer0_rows_equal=layer0,
                pos_equal=bool(torch.equal(cf["pos"], cp["pos"])),
                seq_lens_equal=bool(torch.equal(sf, sp)), k4_launches=k4,
                k4_launches_bf16=k4_b, bf16_flash_rel_rms_err=rel_rms(lf_b, lp),
                bf16_prefill_rel_rms_err=rel_rms(lp_b, lp),
                logits_bitwise_equal=bool(torch.equal(lf_b, lp_b)))
    del cf, cp
    print("  " + json.dumps(line), flush=True)
    check(bool((err <= tol + tol * lp.abs()).all()),
          f"fp32 prefill_flash logits differ from prefill's by {float(err.max())}")
    check(kv_rel <= 1e-4, f"fp32 prefill_flash K/V rows differ from prefill's by {kv_rel} of max")
    check(layer0 and line["pos_equal"] and line["seq_lens_equal"],
          "prefill_flash wrote other cache rows than prefill")
    check(k4 == n_layers and k4_b == n_layers,
          f"prefill_flash launched K4 {k4} (fp32) and {k4_b} (bf16) times")
    check(line["bf16_flash_rel_rms_err"] <= 1.5 * line["bf16_prefill_rel_rms_err"],
          f"bf16 prefill_flash is further from fp32 than prefill: {line}")
    return line


# ---------------------------------------------------------------------------
# phase 8: Mamba-2 (mamba2-1.3b) served by speculative decoding, K6 on the path


def phase_mamba_parity(torch, np, m, tree_to):
    """fp32, mamba2-1.3b cut to 2 layers (widths kept) with its draft cut to
    2 layers: prefill of 3 ragged prompts padded to 512 (K6: 2 chunks of
    256) and 8 greedy steps on the card against the CPU; the chunked
    forward (K6) against the same prompts fed token by token through
    decode_step + commit; speculative generate(s) == generate(0)."""
    R = m.R
    tcfg = R.get_config("mamba2-1.3b").with_(n_layers=2)
    dcfg = R.get_draft_config("mamba2-1.3b").with_(n_layers=2)
    tgt = R.build_model(tcfg)
    gen = torch.Generator().manual_seed(17)
    tp_cpu = tgt.init(gen, torch.float32, "cpu")
    dp_cpu = R.build_model(dcfg).init(gen, torch.float32, "cpu")
    tp_gpu, dp_gpu = tree_to(tp_cpu, "cuda"), tree_to(dp_cpu, "cuda")
    rng = np.random.default_rng(19)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (3, 512)).astype(np.int64))
    lens = torch.tensor([512, 300, 77], dtype=torch.int32)
    k6_0, plain_0 = m.K6.KERNEL.launches, m.ops.PLAIN_SSD.launches
    lg_gpu, tk_gpu = greedy_logits(torch, tgt, tp_gpu, tokens, lens, 8, 0, "cuda")
    torch.cuda.synchronize()
    k6_prefill = m.K6.KERNEL.launches - k6_0
    plain_gpu = m.ops.PLAIN_SSD.launches - plain_0
    lg_cpu, tk_cpu = greedy_logits(torch, tgt, tp_cpu, tokens, lens, 8, 0, "cpu")
    tol = 2e-3   # fp32 both sides; as phase 3
    err = (lg_gpu - lg_cpu).abs()
    ok_logits = bool((err <= tol + tol * lg_cpu.abs()).all())
    same = bool((tk_gpu == tk_cpu).all())
    # chunked (K6, 2 chunks of 256 over 512 rows) against the recurrence
    toks = tokens.to("cuda")
    with torch.no_grad():
        full, _ = tgt.forward(tp_gpu, toks)
    cache = tgt.init_cache(3, 0, torch.float32, "cuda")
    seq = torch.ones(3, dtype=torch.int32, device="cuda")
    steps = []
    for t in range(toks.shape[1]):
        lg, out = tgt.decode_step(tp_gpu, toks[:, t:t + 1].to(torch.int32), cache, seq)
        cache = tgt.commit(out, torch.zeros_like(seq))
        steps.append(lg[:, 0])
        seq = seq + 1
    rec = torch.stack(steps, 1)
    rerr = (full - rec).abs()
    ok_rec = bool((rerr <= tol + tol * rec.abs()).all())
    del full, rec, steps
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=12, dtype=torch.float32, device="cuda")
    toks_np, lens_np = tokens.numpy().astype(np.int32), lens.numpy()
    ref, _, _ = eng.generate(tp_gpu, dp_gpu, toks_np, lens_np, s=0, cache_len=544)
    spec_equal = {}
    for s in (1, 2, 4):
        out, _, _ = eng.generate(tp_gpu, dp_gpu, toks_np, lens_np, s=s, cache_len=544)
        spec_equal[s] = bool((out == ref).all())
    line = dict(logits_max_abs_err=float(err.max()), tol=tol, greedy_tokens_equal=same,
                min_top2_margin=top2_margin(torch, lg_cpu), k6_launches_prefill=k6_prefill,
                plain_ssd_on_card=plain_gpu, chunked_vs_recurrent_max_abs_err=float(rerr.max()),
                spec_equals_greedy=spec_equal)
    print("  " + json.dumps(line), flush=True)
    check(k6_prefill == tcfg.n_layers, f"the card's prefill launched K6 {k6_prefill} times")
    check(plain_gpu == 0, "the plain SSD scan ran on the card")
    check(ok_logits, f"card vs CPU logits differ by {float(err.max())} > {tol}")
    check(same, "card vs CPU greedy tokens differ")
    check(ok_rec, f"chunked forward vs recurrence differ by {float(rerr.max())} > {tol}")
    check(all(spec_equal.values()), f"speculative tokens differ from greedy: {spec_equal}")
    return line


def phase_mamba_serve(torch, m):
    """The paper's profile -> LUT -> adaptive loop on mamba2-1.3b at full
    width and depth with its dense_draft, bf16, phase 4's other flags; K6,
    K5 and K1 (the draft) counted around it and no plain version."""
    counters = (m.K1.KERNEL, m.K5.FWD, m.K6.KERNEL, m.ops.PLAIN, m.ops.PLAIN_RMSNORM,
                m.ops.PLAIN_SSD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    res = m.serve.main(["--arch", "mamba2-1.3b", "--device", "cuda", "--dtype", "bfloat16",
                        "--max-batch", "8", "--cache-len", "256", "--profile-bs", "1,2,4,8",
                        "--s-max", "6", "--requests", "16", "--interval", "0.1",
                        "--max-new", "32"])
    torch.cuda.synchronize()
    launches = dict(k1=m.K1.KERNEL.launches, k5=m.K5.FWD.launches, k6=m.K6.KERNEL.launches,
                    plain=m.ops.PLAIN.launches, plain_rmsnorm=m.ops.PLAIN_RMSNORM.launches,
                    plain_ssd=m.ops.PLAIN_SSD.launches)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["launches"] = launches
    print(json.dumps({"phase": "mamba_serve", **res}), flush=True)
    check(launches["k6"] > 0, "the Mamba-2 serving path never launched K6")
    check(launches["k5"] > 0, "the Mamba-2 serving path never launched K5")
    check(launches["k1"] > 0, "the Mamba-2 serving path never launched K1 (the draft)")
    check(launches["plain"] + launches["plain_rmsnorm"] + launches["plain_ssd"] == 0,
          "a plain version ran on the card")
    grid = [t for d in res["grid_s_per_token"].values() for t in d.values()]
    check(all(math.isfinite(t) and t > 0 for t in grid), "profiling grid not finite")
    check(res["adaptive"]["n"] == 16 and res["no_spec"]["n"] == 16,
          "not every request finished")
    return res


def phase_mamba_continuous(torch, np, m, lut_table):
    """bf16, full width and depth: serve_continuous_live on a contiguous
    pool of 8 slots, 16 requests of 64-256 prompt tokens and 32 new, with
    the LUT of the Mamba-2 serve loop; K6 counted inside prefill_into."""
    R, bf16 = m.R, torch.bfloat16
    tcfg, dcfg = R.get_config("mamba2-1.3b"), R.get_draft_config("mamba2-1.3b")
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    ctrl = m.AdaptiveController(lut=m.SpeculationLUT({int(b): int(v)
                                                      for b, v in lut_table.items()}))
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 16, (64, 256), 32, 0.05, 29)
    in_prefill = {"k6": 0, "prefills": 0}
    prefill_into = eng.prefill_into

    def counted_prefill(*a, **kw):   # K6's launches inside prefill_into
        k0 = m.K6.KERNEL.launches
        out = prefill_into(*a, **kw)
        if not kw.get("warm"):
            in_prefill["k6"] += m.K6.KERNEL.launches - k0
            in_prefill["prefills"] += 1
        return out
    eng.prefill_into = counted_prefill
    eng.load_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (m.K1.KERNEL, m.K5.FWD, m.K6.KERNEL, m.ops.PLAIN, m.ops.PLAIN_RMSNORM,
              m.ops.PLAIN_SSD):
        c.launches = 0
    t0 = time.perf_counter()
    res = m.serve_continuous_live(reqs, eng, tp, dp, ctrl, capacity=8, cache_len=512)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(k1=m.K1.KERNEL.launches, k5=m.K5.FWD.launches, k6=m.K6.KERNEL.launches,
                    k6_in_prefill_into=in_prefill["k6"], prefills=in_prefill["prefills"],
                    plain=(m.ops.PLAIN.launches + m.ops.PLAIN_RMSNORM.launches
                           + m.ops.PLAIN_SSD.launches))
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    busy = sum(b.duration for b in res.batches)
    line = dict(
        requests=len(reqs), finished=len(done), wall_s=wall,
        ttft=dataclasses.asdict(m.ttft_summary(res)), itl=dataclasses.asdict(m.itl_summary(res)),
        tokens_per_s=sum(r.n_generated for r in res.requests) / busy,
        goodput=m.goodput(res), steps=len(res.batches),
        mean_occupancy=m.mean_occupancy(res), s_used=sorted({b.s_used for b in res.batches}),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    print("  " + json.dumps(line), flush=True)
    # where one step's time goes (after the run: its launches are not counted)
    rng = np.random.default_rng(31)
    toks = rng.integers(0, tcfg.vocab_size, (8, 16)).astype(np.int32)
    lens = np.full((8,), 16, np.int32)
    line["profile"] = {f"b8_s{s}": profile_step(torch, eng, tp, dp, f"mamba_b8_s{s}",
                                                eng.prefill(tp, dp, toks, lens, 256), s)
                       for s in (0, 3)}
    check(all(v["device_busy_ms"] > 0 for v in line["profile"].values()),
          "the profiler saw no device time")
    line["profile_prefill"] = profile_prefill(torch, np, eng.target, tp, tcfg.vocab_size)
    check(line["profile_prefill"]["k6_ms"] > 0, "the profiled prefill ran no K6")
    check(len(done) == len(reqs), f"{len(reqs) - len(done)} requests did not finish")
    check(launches["k6"] > 0 and launches["k6_in_prefill_into"] == launches["k6"],
          f"K6 did not run in prefill_into only: {launches}")
    check(launches["k1"] > 0 and launches["k5"] > 0, f"K1 or K5 never launched: {launches}")
    check(launches["plain"] == 0, "a plain version ran on the card")
    return line


def train_kernel_rows(trows, launches, k5_serve, k5_live, distill, pflash):
    """The ``kernels`` line's K4 and K5 rows, forward and backward, at the
    trainer's shapes (internlm2-1.8b, fp32), with the trainer's launches,
    and K4's bf16 forward at ``prefill_flash``'s shape with phase 7's
    ``prefill_flash`` launches.  K4's fp32 bounds are counted for its route,
    three tf32 products (``bound_route``), beside the SIMT figure; its
    backward row adds its split count, device kernels a call and the bf16
    backward at the same shape; so does K5's (its plan for the split), with
    the forward + backward time beside the library's forward + backward."""
    flash = next(r for r in trows if r["case"] == "flash_internlm2_train")
    norm = next(r for r in trows if r["case"] == "rmsnorm_internlm2_train")
    pre = next(r for r in trows if r["case"] == "flash_prefill_flash_t512")
    out = []
    for name, r, src, rep, lib in (
            ("flash_attn", flash, "flash_attn.cu", "src/repro/kernels/flash_attn.py:71", "SDPA"),
            ("rmsnorm", norm, "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24",
             "torch.nn.functional.rms_norm")):
        key = "k4" if name == "flash_attn" else "k5"
        common = {"route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
                  "replaces": rep, "launches_from": "phase 7, the internlm2-1.8b trainer "
                                                    "(20 steps)"}
        out.append({"name": f"{name}_fwd", **common, "launches": launches[f"{key}_fwd"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"], "library": lib,
                    "shape": f"{r['shape']}, fp32"})
        out.append({"name": f"{name}_bwd", **common, "launches": launches[f"{key}_bwd"],
                    "max_abs_err": r["grad_max_abs_err"], "ms": r["bwd_ms"],
                    "plain_ms": r["bwd_plain_ms"], "bound_ms": r["bwd_bound_ms"],
                    "bound_by": r["bwd_bound_by"], "library_ms": r["bwd_library_ms"],
                    "library": lib + " forward + backward (autograd)",
                    "shape": f"{r['shape']}, fp32"})
    k4f, k4b = out[0], out[1]
    k4f["bound_by"] = "bytes" if flash["bound_by"] == "bytes" else "operations"
    k4f["bound_route"], k4f["bound_simt_ms"] = "3xTF32", flash["bound_simt_ms"]
    k4b["bound_route"], k4b["bound_simt_ms"] = "3xTF32", flash["bwd_bound_simt_ms"]
    k4b["n_splits"] = flash["bwd_n_splits"]
    k4b["device_kernels_per_call"] = flash["bwd_device_kernels"]
    k4b["fwd_plus_bwd_ms"] = flash["fwd_plus_bwd_ms"]
    bf = next(r for r in trows if r["case"] == "flash_internlm2_train_bf16")
    k4b["bf16"] = {k: bf[k] for k in ("shape", "bwd_ms", "bwd_library_ms", "bwd_bound_ms",
                                      "grad_rel_rms", "sdpa_grad_rel_rms", "bwd_n_splits",
                                      "fwd_plus_bwd_ms")}
    k5b = out[3]
    k5b["fwd_plus_bwd_ms"] = norm["fwd_plus_bwd_ms"]
    k5b["library"] = "torch.nn.functional.rms_norm forward + backward (autograd)"
    k5b["device_kernels_per_call"] = norm["bwd_device_kernels"]
    k5b["plan"] = norm["bwd_plan"]
    nbf = next(r for r in trows if r["case"] == "rmsnorm_internlm2_train_bf16")
    k5b["bf16"] = {k: nbf[k] for k in ("shape", "bwd_ms", "fwd_plus_bwd_ms", "bwd_library_ms",
                                       "bwd_bound_ms", "grad_max_abs_err", "grad_tol",
                                       "bwd_device_kernels")}
    out[2]["launches_serving"] = {"phase 4": k5_serve, "phase 6b": k5_live}
    out[0]["launches_distill"] = distill["launches"]["k4_fwd"]
    out.insert(1, {"name": "flash_attn_fwd_bf16", **{k: out[0][k] for k in (
        "route", "source", "replaces")}, "launches": pflash["k4_launches_bf16"],
        "launches_from": "phase 7, prefill_flash on OPT-6.7B in bf16 (one per layer)",
        "max_abs_err": pre["max_abs_err"], "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"], "library": "SDPA", "shape": f"{pre['shape']}, bf16"})
    return out


def ssd_kernel_row(srows, launches, launches_live):
    """The ``kernels`` line's K6 row at the continuous path's largest
    prefill (B 1, T 256, bf16), with the launches of phase 8's serve loop
    (the main path) and of its continuous run."""
    r = next(r for r in srows if r["case"] == "ssd_serve_b1_t256_bf16")
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:52", "launches": launches,
            "launches_from": "phase 8, the mamba2-1.3b serve loop",
            "launches_continuous": launches_live,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "library": "none", "shape": r["shape"] + ", bf16",
            "device_kernels_per_call": r["device_kernels"]}


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
    from repro_torch import training
    from repro_torch.kernels import build, ops, paged, ref, tuning
    from repro_torch.kernels import flash_attn as K4
    from repro_torch.kernels import paged_verify_attn as K23
    from repro_torch.kernels import rmsnorm as K5
    from repro_torch.kernels import spec_verify_attn as K1
    from repro_torch.kernels import ssd_chunk as K6
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import metrics, scheduler
    from repro_torch.serving.request import Request
    from repro_torch.training import train_step

    # what phases 6 and 7 drive, under one name
    m = types.SimpleNamespace(
        SpecDecodeEngine=SpecDecodeEngine, Request=Request, K1=K1, K23=K23, K4=K4, K5=K5,
        K6=K6, serve=serve,
        ops=ops, paged=paged, host_cu_blocks=tuning.host_cu_blocks,
        grid_steps_ragged=tuning.grid_steps_ragged,
        grid_steps_dense=tuning.grid_steps_dense,
        AdaptiveController=adaptive.AdaptiveController,
        SpeculationLUT=adaptive.SpeculationLUT, fixed_controller=adaptive.fixed_controller,
        LatencyModel=analytical.LatencyModel,
        ContinuousEngineBackend=scheduler.ContinuousEngineBackend,
        ContinuousScheduler=scheduler.ContinuousScheduler,
        SimStepBackend=scheduler.SimStepBackend, replay_sources=scheduler.replay_sources,
        serve_continuous_live=scheduler.serve_continuous_live,
        PrefillBudgetAdmit=scheduler.PrefillBudgetAdmit,
        ttft_summary=metrics.ttft_summary, itl_summary=metrics.itl_summary,
        goodput=metrics.goodput, mean_occupancy=metrics.mean_occupancy,
        R=R, DecoderLM=DecoderLM, train=train, measure_acceptance=adaptive.measure_acceptance,
        DataConfig=training.DataConfig, batch_at=training.batch_at,
        AdamWConfig=training.AdamWConfig, init_adamw=training.init_adamw,
        adamw_update=training.adamw_update, make_train_step=training.make_train_step,
        make_loss_fn=training.make_loss_fn, make_distill_step=training.make_distill_step,
        value_and_grad=train_step.value_and_grad)

    def tree_to(tree, device):
        return tree_map(lambda t: t.to(device), tree)

    t_all = time.perf_counter()
    # ---- 1. device + build ----
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = build.build(["spec_verify_attn", "paged_verify_attn", "flash_attn", "rmsnorm",
                        "ssd_chunk"])
    build_s = time.perf_counter() - t0
    ptxas = [f"{name}: {ln}" for name, p in libs.items()
             for ln in ptxas_report(p.with_suffix(".log").read_text())]
    print(json.dumps({"phase": "device", "nvidia_smi": card,
                      "kind": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_s": build_s}), flush=True)
    for ln in ptxas:
        print("  ptxas: " + ln)
    print("  k2/k3 occupancy (bs 16, MAXB 32): " + json.dumps({
        f"{dt}{'_int8' if q8 else ''}_hd{hd}": K23.occupancy(
            getattr(torch, dt), torch.int8 if q8 else getattr(torch, dt), hd, 16, 32)
        for dt in ("float32", "bfloat16") for hd in (64, 128) for q8 in (False, True)}),
        flush=True)
    print("  k1 occupancy (L 512; row tile 16 / 64): " + json.dumps({
        f"{dt}{'_int8' if q8 else ''}_hd{hd}_rt{rt}": K1.occupancy(
            getattr(torch, dt), torch.int8 if q8 else getattr(torch, dt), hd, rt, 512)
        for dt in ("float32", "bfloat16") for hd in (64, 128) for q8 in (False, True)
        for rt in K1.ROW_TILES}), flush=True)
    print("  k4 forward occupancy: " + json.dumps({
        f"{dt}_hd{hd}": K4.fwd_occupancy(getattr(torch, dt), hd)
        for dt in ("float32", "bfloat16") for hd in (64, 128)}), flush=True)
    print("  k4 backward occupancy (dq, dkv): " + json.dumps({
        f"{dt}_hd{hd}": K4.bwd_occupancy(getattr(torch, dt), hd)
        for dt in ("float32", "bfloat16") for hd in (64, 128)}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("  k5 backward occupancy (rows blocks an SM at the plans of phase 2c's grads cases): "
          + json.dumps({f"{dt}_n{n}_d{d}": dict(plan=plan, blocks_per_sm=K5.occupancy(
              getattr(torch, dt), plan))
              for dt, n, d in (("float32", 1024, 2048), ("float32", 1024, 768),
                               ("bfloat16", 1024, 2048), ("float32", 128, 2048),
                               ("float32", 257, 1000), ("bfloat16", 257, 1001))
              for plan in [K5.bwd_plan(n, d, sms, getattr(torch, dt).itemsize)]}), flush=True)
    print("  k6 occupancy (mamba2-1.3b, plans at B 8 T 16, B 1 T 256, B 4 T 2048): "
          + json.dumps({f"{dt}_b{b}_t{t}": dict(plan=plan, **K6.occupancy(
              getattr(torch, dt), 64, 128, t, q, 64, 1, plan))
              for dt in ("float32", "bfloat16") for b, t, q in ((8, 16, 16), (1, 256, 256),
                                                                (4, 2048, 256))
              for plan in [K6.ssd_plan(b, t, 64, 1, 64, 128, q, sms)]}), flush=True)

    # ---- 2. kernels ----
    rows = phase_kernels(torch, K1, ref)
    print(json.dumps({"phase": "kernels", "cases": len(rows), "ok": True}), flush=True)

    # ---- 2b. paged kernels ----
    prows = phase_paged_kernels(torch, np, K23, paged, ref)
    print(json.dumps({"phase": "paged_kernels", "cases": len(prows), "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 2c. K4 and K5, forward and backward ----
    trows = phase_train_kernels(torch, K4, K5, ref)
    print(json.dumps({"phase": "train_kernels", "cases": len(trows), "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 2d. K6, the SSD scan ----
    srows = phase_ssd_kernels(torch, K6, ref)
    print(json.dumps({"phase": "ssd_kernels", "cases": len(srows), "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 3. fp32 parity, card against CPU ----
    phase_parity(torch, np, R, DecoderLM, SpecDecodeEngine, tree_to)
    print(json.dumps({"phase": "parity", "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 4. the main path ----
    torch.cuda.reset_peak_memory_stats()
    for c in (K1.KERNEL, K5.FWD, ops.PLAIN, ops.PLAIN_RMSNORM):
        c.launches = 0
    res = serve.main(["--arch", "opt-6.7b", "--device", "cuda", "--dtype", "bfloat16",
                      "--max-batch", "8", "--cache-len", "256", "--profile-bs", "1,2,4,8",
                      "--s-max", "6", "--requests", "16", "--interval", "0.1",
                      "--max-new", "32"])
    torch.cuda.synchronize()
    launches, k5_serve = K1.KERNEL.launches, K5.FWD.launches
    plain_launches = ops.PLAIN.launches + ops.PLAIN_RMSNORM.launches
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["kernel_launches"] = launches
    res["k5_launches"] = k5_serve
    res["plain_launches"] = plain_launches
    print(json.dumps({"phase": "serve", **res}), flush=True)
    check(launches > 0, "the serving path never launched the verify kernel")
    check(k5_serve > 0, "the serving path never launched K5")
    check(plain_launches == 0, "a plain version ran on the card")
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
    torch.cuda.empty_cache()

    # ---- 6c. chunked prefill on the continuous main path, bf16, full depth ----
    chunked = phase_chunked_serve(torch, np, R, m, res["lut"])
    print(json.dumps({"phase": "chunked_serve", "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 7. the training path: distillation, the trainer, card vs CPU, prefill_flash ----
    distill = phase_distill(torch, np, R, m)
    print(json.dumps({"phase": "distill", "ok": True}), flush=True)
    torch.cuda.empty_cache()
    trained = phase_train(torch, m)
    print(json.dumps({"phase": "train", "ok": True}), flush=True)
    torch.cuda.empty_cache()
    phase_train_parity(torch, np, m, tree_to)
    print(json.dumps({"phase": "train_parity", "ok": True}), flush=True)
    torch.cuda.empty_cache()
    pflash = phase_prefill_flash(torch, np, R, m)
    print(json.dumps({"phase": "prefill_flash", "ok": True}), flush=True)
    torch.cuda.empty_cache()

    # ---- 8. Mamba-2: card vs CPU, the serve loop and the continuous runtime ----
    phase_mamba_parity(torch, np, m, tree_to)
    print(json.dumps({"phase": "mamba_parity", "ok": True}), flush=True)
    torch.cuda.empty_cache()
    mserve = phase_mamba_serve(torch, m)
    torch.cuda.empty_cache()
    mlive = phase_mamba_continuous(torch, np, m, mserve["lut"])
    print(json.dumps({"phase": "mamba_continuous", "ok": True}), flush=True)

    head = next(r for r in rows if r["case"] == "target_verify_s3_b8_bf16")
    pre = next(r for r in rows if r["case"] == "cont_target_prefill_t256_bf16")
    keys = ("case", "shape", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "n_splits", "device_kernels")
    k1_chunk = [{k: r[k] for k in keys} for r in rows
                if r["case"].startswith("chunk_") and r["dtype"] == "bfloat16"]
    k3_chunk = [{k: r[k] for k in keys} for r in prows
                if "_chunk_" in r["case"] and r["dtype"] == "bfloat16"]
    mixed_keys = keys + ("verify_call_ms", "chunk_call_ms", "two_launch_ms",
                         "mixed_over_two_launch")
    k3_mixed = [{k: r[k] for k in mixed_keys} for r in prows
                if r["case"].startswith("mixed_") and r["dtype"] == "bfloat16"]
    phead = next(r for r in prows if r["case"] == "opt_pool_full_t1_bf16")
    paged_shape = "target verify s=0, " + phead["shape"] + ", bf16"
    paged_common = {"max_abs_err": phead["max_abs_err"], "plain_ms": phead["plain_ms"],
                    "bound_ms": phead["bound_ms"], "bound_by": phead["bound_by"],
                    "library_ms": phead["library_ms"], "library": phead["library"],
                    "n_splits": phead["n_splits"],
                    "device_kernels_per_call": phead["device_kernels"], "shape": paged_shape}
    print(json.dumps({"kernels": [{
        "name": "spec_verify_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spec_verify_attn.cu",
        "replaces": "src/repro/kernels/spec_verify_attn.py:126",
        "launches": launches, "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library": "SDPA", "n_splits": head["n_splits"],
        "device_kernels_per_call": head["device_kernels"],
        "shape": "target verify s=3, " + head["shape"] + ", bf16",
        "launches_continuous": live["launches"]["k1"],
        "prefill": {k: pre[k] for k in keys},
        "chunk": k1_chunk, "launches_chunked": chunked["launches"]["k1"],
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
        "chunk": k3_chunk, "launches_chunked": chunked["launches"]["k3"],
        "mixed": {"cases": k3_mixed,
                  "launches": chunked["mixed_launch"]["launches"]["k3"],
                  "launches_from": "phase 6c with mixed_launch=True: 32 x (steps + final "
                                   "chunks + flushed chunks)",
                  "fused_steps": chunked["mixed_launch"]["fused_steps"]},
        **paged_common}] + train_kernel_rows(trows, trained["launches"], k5_serve,
                                             live["launches"]["k5"], distill, pflash)
        + [ssd_kernel_row(srows, mserve["launches"]["k6"], mlive["launches"]["k6"])]}),
        flush=True)
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
