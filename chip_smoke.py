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
            inputs), at the card-vs-CPU train step's 128 rows, at the
            Mamba-2 trainer's rows (2048 x 2048 and 2048 x 4096, fp32) and
            at odd widths (d 1000; d 1001, one-value accesses); two calls
            must agree bit for bit and issue the device kernels of the
            wrapper's plan, all ``rmsnorm_*``.  Every K5 row gives its
            forward's plan (``fwd_plan``) and the device kernels a call
            issues (one, ``rmsnorm_fwd_kernel*``), and holds each row of
            the full call bit for bit against calls of 1 row, of the
            first 37 rows and of the rest (``row_independent``).
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
6e. kv_quant  the int8 KV cache (``kv_quant`` on both models): the
            full-width pair cut to 2 layers, fp32, on phase 6a's trace
            served paged (12 blocks, preempting), contiguous, chunked and
            mixed, a shared-prompt trace served with the prefix cache (hits,
            zero-suffix admissions, one through a copy-on-write), and solo
            ``generate``: equal tokens, but where the solo stream's top-2
            margin is below 4e-3 (a code that a round-half tie moves shifts
            the logits by up to 2e-3; such divergences are reported);
            speculative == greedy; every StepTrace replayed; K2 == K3
            through the model's paged ``decode_step``; card against CPU
            (logits 2e-3, codes at most 1 apart on at most 1e-3 of them,
            layer 0's scales 1e-6 relative, deeper layers' 2e-3, their
            inputs moved as the logits are by the moved codes).  Then bf16
            at full depth: phase 6b's pair, trace and LUT on the bf16 pool
            of 144 blocks and on an int8 pool of 283 blocks (the same
            bytes): every request finished, no preemption, K1 and K3
            launched over int8 only, greedy agreement with the bf16 run;
            layer 0's dequantised rows within 1.01 stored scales of the
            bf16 rows, every row's largest |code| 127, the first step's
            logits within 0.05 relative RMS of the fp32 unquantised route;
            one profiled paged step at B = 16, s = 0 of each pool.  K1's and
            K3's int8 routes also have phase 2/2b rows at these shapes.
6f. sampling  stochastic speculative sampling (``sample=True``): in fp32
            the full-width OPT-6.7B as its own draft (the same parameters)
            accepts every draft token at s 3, B 4, in each of 3 steps; the
            2-layer cut on the card against the CPU, both fed the same draws
            (made on the CPU, through ``_sample_draws``): tokens equal but
            at a near-tie (the CPU step's smallest decision margin below
            twice the greedy logits' card-vs-CPU deviation).  In bf16 on
            phase 6b's pair and seed: 8192 rows of one 16-token prompt
            through one s = 3 step and one s = 0 step (1024 rows a call):
            their first tokens, in 16 bins of equal target mass (the
            target's softmax from a prefill on the card), pass a chi-square
            test (p > 1e-3) and the draft's own first proposals fail it;
            the rate of accepted first draft tokens within 4 sigma of
            sum_v min(p, q); 0 <= a <= s, committed <= a + 1, tokens in the
            vocabulary; K1 and K3 launched, no plain version.  Measured:
            acceptance at s 1, 3 and 5 over 64 prompts, phase 4's profile on
            a reduced grid (b 1, 4, 8; s 0, 1, 3) greedy and sampled, and
            step profiles greedy against sampled (ring B 8 s 3, paged B 16
            s 0 and s 3).
6g. telemetry  the ``Telemetry`` hub on phase 6b's pair (the target cut
            to 16 layers since phase 9), pool and trace with every arrival
            at 0, sampled at s = 3: no hub, a hub, and a
            hub with ``jsonl_path`` and ``profile_dir`` under ``build/``:
            tokens and StepTrace equal, preempted, every request retired,
            committed tokens counted, a ``repro/step[...]`` scope in the
            profiler's trace, ``engine.annotate`` restored; the wall times
            (not gated), each scope's device time from the trace's
            ``gpu_user_annotation`` ranges, the acceptance observatory.
7.  train   the training path: the full-width OPT-125M draft distilled for
            20 steps against phase 4's OPT-6.7B teacher (the KL must fall;
            acceptance at s = 4 before and after); the internlm2-1.8b
            trainer (``repro_torch.launch.train``) at full width and depth,
            fp32, 20 steps, loss falling, K4/K5 launched and no plain
            version, peak memory and the device-busy share; one train step
            of internlm2 cut to 2 layers on the card against the CPU; the
            mamba2-1.3b trainer at full width and depth, fp32, B 4, T 512
            (two chunks), 20 steps, loss falling, K6's forward and backward
            launched once per layer a step, K5 launched, no plain version,
            peak memory, the device-busy share and K6's and K5's shares;
            one Mamba-2 train step cut to 2 layers (B 2, T 512) on the card
            against the CPU (loss 1e-5, grads 1e-4 of each max); and
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
            library call computes it).  Then K6's backward against the
            plain backward: the trainer's call (B 4, T 512), T 2048 (8
            chunks), T 300 (Q 150), one chunk (three device kernels), G 8,
            the smoke widths with h0 and dh_final, strong decay, an h0 and
            a dh_final over two chunks and over one, heads of 128 (the
            build for P above 64) with N 64; fp32 within 1e-4 of
            each gradient's largest entry of the plain backward and of an
            fp64 evaluation of it, bf16 elementwise within 1e-2 of the
            plain backward of the same bf16 inputs; finite, bit for bit
            from call to call and through autograd, the forward's kept
            states leaving y unchanged, its device kernels all ``ssd_*``.
8.  mamba2  Mamba-2 served by speculative decoding: mamba2-1.3b cut to 2
            layers (widths kept) with its draft cut to 2 layers, fp32, card
            against CPU (prefill of prompts padded to 512, 8 greedy steps),
            the chunked forward (K6) against the token-by-token recurrence,
            and speculative generate(s) == generate(0); then the serve loop
            of phase 4 on mamba2-1.3b at full width, cut to 24 of its 48
            layers since phase 9 (``MAMBA_SERVE_LAYERS``), in bf16, its
            profile over s 0-3, 8 requests (K6,
            K5 and K1 counted, no plain version); then
            ``serve_continuous_live`` on a contiguous pool of 8 slots, 16
            requests of 64-256 prompt tokens, with that loop's LUT (K6
            counted inside ``prefill_into``), one step of that pair at
            B = 8, s = 0 and 3 under ``torch.profiler``, and one B = 1,
            T 256 target prefill under it (device time, K6's share).
9.  qwen3 / yi  qwen3-8b (per-head q/k norms through K5), yi-34b (G 7) and
            qwen3-moe-30b-a3b (128 experts, top-8).  9a: each cut to 2
            layers at full width with its draft cut to 2, fp32, on the
            same parameters on the CPU and the card: prefill logits and a
            ring and a paged s = 3 verify's within 2e-3; K5 launched
            4 (Qwen3) or 2 (yi) times a layer and once for the final
            norm in a prefill; speculative (s 3) = greedy (s 0) tokens
            over 16 new tokens at B 4, ring and paged; for the MoE, at
            the capacity factor n_experts / top_k (16: no assignment can
            drop, so a token does not depend on the rows beside it), and
            there the mixed step's tokens equal flush-then-step's; the
            ``einsum`` and ``gather`` dispatches on layer 0 within 1e-5
            relative (outputs and aux) at 16 and at the config's 1.25,
            where both keep the same assignments and some drop.  9b: each
            at full size in bf16, one after the other (each freed before
            the next): the sampled per-token grid at b 1, 8, 16 x s 0, 3
            and its LUT; ``serve_continuous_live`` of 16 requests of
            phase 6b's trace, sampled, with that LUT on 16 slots and as
            many blocks of 16 as memory allows (at most 512, at least
            144): every request finished, every token in the true
            vocabulary, K1, K3 and K5 launched exactly as
            ``predicted_launches`` counts them from the run's admissions
            and steps, no plain version, peak memory below the card's;
            TTFT, ITL, tokens/s, acceptance, and for the MoE the share of
            dropped assignments at 1.25 (from the recorded router inputs,
            real rows apart); then paged B 16 steps at s 0 and 3 under
            ``torch.profiler`` (wall, busy, idle share, device kernels,
            the five costliest kernels, K3's and K5's shares) beside the
            weight bytes over 3.35 TB/s.  Phase 2c holds K5 at the
            ``qk_norm`` rows (d 128) too.

Every serving phase now runs K5 (every norm), and phases 4, 6b, 8 and 9
gate its launches; phase 5 records its time per step.

Each phase's line gives its seconds (``s``).  Every ``torch.profiler``
trace that a gate reads is taken again, three times at most, while it
lacks every kernel of a kind that its launch count says ran
(``whole_profile``: the profiler now and then drops device events); its
row gives ``profile_takes`` and ``profile_lost``, the counted launches the
kept trace lacks.

Exits non-zero, printing no verdict, without CUDA or when any phase fails.
Everything it prints also goes to ``chiprun_out/chip_smoke.log`` beside it,
since a remote run may return only the tail of standard output.
"""
from __future__ import annotations

import contextlib
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


def device_kernels(torch, fn, args, expect=None):
    """The names of the device kernels a call of ``fn`` launches
    (``torch.profiler``), in order, each once: the union over 3 calls,
    since the profiler now and then drops a call's device events.  With
    ``expect`` (the count the caller's rule gives), profiles again, up to 5
    times, while the union holds fewer names (it once kept 2 of a call's 5
    in all 3 calls); more names than that, or other ones, still show."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    seen = {}
    for _ in range(5):   # ... or hands back none at all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.update(dict.fromkeys(names))
        if seen and (expect is None or len(seen) >= expect):
            break
    return list(seen)


def serving_kinds():
    """The serving kernels' launch counts, each beside the names of the
    device kernels one launch issues (at least one of them), for
    ``whole_profile``: K1, K2 and K3, K5's forward and K6's forward."""
    from repro_torch.kernels import paged_verify_attn as K23
    from repro_torch.kernels import rmsnorm as K5
    from repro_torch.kernels import spec_verify_attn as K1
    from repro_torch.kernels import ssd_chunk as K6
    return [(lambda: K1.KERNEL.launches, {"verify_kernel"}),
            (lambda: K23.DENSE.launches + K23.RAGGED.launches, {"paged_verify_kernel"}),
            (lambda: K5.FWD.launches, {"rmsnorm_fwd_kernel"}),
            (lambda: K6.KERNEL.launches, {"ssd_scan", "ssd_states", "ssd_carry",
                                           "ssd_outputs"})]


def train_kinds(m):
    """The training kernels' launch counts for ``whole_profile``: K4's
    forward and backward, K5's and K6's forward and backward."""
    return [(lambda: m.K4.FWD.launches, {"fwd_kernel"}),
            (lambda: m.K4.BWD.launches, {"flash_bwd_dq", "flash_bwd_dkv"}),
            (lambda: m.K5.FWD.launches, {"rmsnorm_fwd_kernel"}),
            (lambda: m.K5.BWD.launches, {"rmsnorm_bwd_rows"}),
            (lambda: m.K6.KERNEL.launches, {"ssd_scan", "ssd_states", "ssd_carry",
                                             "ssd_outputs"}),
            (lambda: m.K6.KERNEL_BWD.launches, {"ssd_bwd_keys"})]


def whole_profile(torch, body, activities, kinds, reset=None, tries=3):
    """``torch.profiler`` over ``body()``, taken again (``tries`` times at
    most, ``reset()`` before each retake) while the trace holds no device
    event, or no device kernel of a kind whose launch count rose during it:
    ``kinds`` pairs a function that reads a launch count with the names of
    the device kernels each of its launches issues, one at least.  The
    profiler now and then drops device events (see ``device_kernels``; a
    step's device kernels are often not a whole number), and a trace that
    lost a kernel's would read as that kernel's not having run.  Returns
    the profiler, the takes, and the launches of those kinds that the trace
    it returns lacks."""
    from torch.profiler import profile
    cuda = torch.autograd.DeviceType.CUDA
    for take in range(1, tries + 1):
        if take > 1 and reset is not None:
            reset()
        before = [count() for count, _ in kinds]
        with profile(activities=activities) as prof:
            body()
            torch.cuda.synchronize()
        names = [kernel_name(e.name) for e in prof.events() if e.device_type == cuda]
        rose = [count() - b for (count, _), b in zip(kinds, before)]
        seen = [sum(n in ks for n in names) for _, ks in kinds]
        if names and all(k > 0 for r, k in zip(rose, seen) if r > 0):
            break
    return prof, take, sum(max(0, r - k) for r, k in zip(rose, seen))


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
    import torch.nn.functional as F
    G = c["q"].shape[2] // c["k"].shape[2]
    lib_sets = [(s[0].transpose(1, 2), s[1], s[2],
                 visible(torch, dict(c, q_pos=s[3], k_pos=s[4]))[:, None], s[5], s[6])
                for s in sets]

    def library(q, k, v, mask, ks, vs):
        if ks is not None:   # int8: dequantise, then SDPA
            k = (k.float() * ks.float()[..., None]).to(q.dtype)
            v = (v.float() * vs.float()[..., None]).to(q.dtype)
        return F.scaled_dot_product_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                              attn_mask=mask, enable_gqa=G > 1)
    library_ms = device_ms(torch, library, lib_sets)
    del sets, lib_sets
    B, T, H, hd = c["q"].shape
    KVH, L = c["k"].shape[2], c["k"].shape[1]
    splits = K1.n_splits(B, KVH, (H // KVH) * T, L,
                         torch.cuda.get_device_properties(0).multi_processor_count)
    names = device_kernels(torch, kernel, args, expect=launch.device_kernels(splits))
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
        # phase 6e (kv_quant): the target prefill of phase 6b's largest
        # bucket into an int8 ring, and the draft's verify over 16 int8 rings
        ("cont_target_prefill_t256_int8", dict(B=1, T=256, H=T_H, KVH=T_KVH, hd=T_HD,
                                               L=512, n_ctx=1, kv_len=212, quant=True)),
        ("cont_draft_verify_t4_b16_int8", dict(B=16, T=4, H=D_H, KVH=D_KVH, hd=D_HD, L=512,
                                               n_ctx=200, quant=True)),
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
        # the gather (and an int8 pool's dequantisation), then SDPA with the
        # position mask
        kg, vg = paged.gather_kv_blocks(k, v, bt)
        if ks is not None:
            kg = (kg.float() * paged.gather_scales(ks, bt).float()[..., None]).to(q.dtype)
            vg = (vg.float() * paged.gather_scales(vs, bt).float()[..., None]).to(q.dtype)
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
    library_ms = device_ms(torch, library, sets)
    bound_ms, bound_by = paged_bound(torch, paged, c)
    del sets
    B, T, H, hd = c["q"].shape
    KVH, bs, MAXB = c["k"].shape[2], c["k"].shape[1], c["bt"].shape[1]
    splits = K23.n_splits(B, KVH, (H // KVH) * T, MAXB, bs,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    names = device_kernels(torch, ragged, args, expect=launch.device_kernels(splits))
    # every device kernel of a call is K3's under phase 5's name filter
    names_ok = (len(names) == launch.device_kernels(splits)
                and all("paged_verify_kernel" in n for n in names))
    return dict(case=c["name"], dtype=c["dtype"], shape=c["shape"], max_abs_err=max_err,
                tol=tol, ok=ok and same and zero_rows and names_ok, k3_equals_k2=same,
                empty_rows_zero=zero_rows, n_splits=splits, device_kernels=len(names),
                kernel_names=[n.split("<")[0].split("::")[-1] for n in names],
                ms=ragged_ms, dense_ms=dense_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library="gather + dequantise + SDPA" if quant else "gather + SDPA (two calls)",
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
        ("opt_pool_full_t1_int8", dict(B=16, T=1, ctx=[192] * 16, quant=True, **opt)),
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
        names = device_kernels(torch, bwd, args, expect=K4.bwd_device_kernels(splits))
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


# K5's phase 2c cases: (name, n, d, dtype, with the backward); every one
# runs the forward
NORM_CASES = [("internlm2_train", 1024, 2048, "float32", True),
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
              ("odd_d1001_bf16", 257, 1001, "bfloat16", True),
              # the mamba2-1.3b trainer's rows (B 4, T 512): norm and final_norm
              # at d 2048, norm_y at d 4096
              ("mamba2_train_d2048", 2048, 2048, "float32", True),
              ("mamba2_train_d4096", 2048, 4096, "float32", True),
              # qk_norm's per-head rows at d 128: qwen3-8b's q (32 heads) and
              # k (8 kv-heads) rows at phase 9b's largest prefill (256
              # tokens), and q rows at the trainer's B 8, T 128 (fwd + bwd)
              ("qwen3_8b_q_prefill_t256", 8192, 128, "bfloat16", False),
              ("qwen3_8b_k_prefill_t256", 2048, 128, "bfloat16", False),
              ("qk_norm_train_b8_t128", 16384, 128, "float32", True)]


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
    fplan = K5.fwd_plan(n, d, nb)
    row["fwd_plan"] = {k: fplan[k] for k in K5.FWD_ARGS + ("threads",)}
    fwd = lambda x_, gm: K5.rmsnorm_fwd_cuda(x_, gm, save_rstd=True)  # noqa: E731
    names = device_kernels(torch, fwd, (x, gamma), expect=fplan["device_kernels"])
    row["fwd_device_kernels"] = len(names)
    row["fwd_kernel_names"] = [kernel_name(n_) for n_ in names]
    ok &= len(names) == fplan["device_kernels"] and all(
        kernel_name(n_).startswith("rmsnorm_fwd_kernel") for n_ in names)
    # a row's bits may not depend on the rows beside it in a call: the full
    # call against calls of 1 row, of the first 37 (fewer where n is
    # smaller) and of the rest
    cut = min(37, n - 1)
    parts = [fwd(x[:1], gamma)] + ([fwd(x[:cut], gamma), fwd(x[cut:], gamma)] if cut else [])
    spans = [(0, 1)] + ([(0, cut), (cut, n)] if cut else [])
    torch.cuda.synchronize()
    row["row_independent"] = all(
        torch.equal(py, y[lo:hi]) and torch.equal(pr, rstd[lo:hi])
        for (py, pr), (lo, hi) in zip(parts, spans))
    ok &= row["row_independent"]
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
        names = device_kernels(torch, bwd, args, expect=plan["device_kernels"])
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
    for i, (name, n, d, dtype, grads) in enumerate(NORM_CASES):
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
        kernel = lambda *a: K6.ssd_chunked_cuda(*a, c["chunk"])[:2]  # noqa: E731

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
    names = [kernel_name(n) for n in device_kernels(torch, kernel, args,
                                                    expect=plan["device_kernels"])]
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


# phase 2d (continued): K6's backward against its plain backward


def ssd_bwd_bound(torch, ref, c, dh_final):
    """Least time for the backward, as the row's ``bound_ms``/``bound_by``:
    every input read once (xh, B, C, dt, A, dy; h0 and dh_final where given)
    and every gradient written once, against the operations these inputs
    need per (batch, chunk): c b^T over the causal half once per group, then
    per head four products over the causal half, D = dy x^T and dx = (S o
    L)^T dy (P wide), db = (L o D)^T c and dc = (L o D dt) b (N wide); the
    dh_out terms (dx, db) where dh_out is not zero (chunks before the last,
    or a dh_final), the h_in term of dc where h_in is not zero (chunks after
    the first, or an h0), and the state of dh where it is wanted (the same).
    bf16 at the bf16 peak; fp32 counts three tf32 products at the tf32 peak;
    ``bound_simt_ms``: the same operations at the fp32 SIMT peak."""
    xh, Bm = c["xh"], c["B"]
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = ref.ssd_chunk_len(T, c["chunk"])
    nc = T // Q
    with_dh = nc - 1 + (dh_final is not None)          # chunks whose dh_out is not zero
    with_h = nc - 1 + (c["h0"] is not None)            # chunks whose h_in is not zero
    tri = Q * (Q + 1)
    ops = Bsz * (nc * (G * tri * N + H * tri * (2 * P + 2 * N))
                 + H * 2 * Q * P * N * (2 * with_dh + 2 * with_h))
    es = xh.element_size()
    state = 4 * Bsz * H * P * N
    nbytes = (2 * (xh.numel() + 2 * Bm.numel()) * es + 2 * 4 * c["dt"].numel() + 2 * 4 * H
              + 4 * xh.numel() + (2 * state if c["h0"] is not None else 0)
              + (state if dh_final is not None else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S
    if c["dtype"] == "float32":
        t_ops, label = 3 * ops / PEAK_OPS["tf32"], "operations (3xTF32)"
    else:
        t_ops, label = ops / PEAK_OPS["bfloat16"], "operations"
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else label,
            "bound_simt_ms": 1e3 * max(t_bytes, ops / PEAK_OPS["float32"]),
            "ops": ops, "bytes": nbytes}


# the head axis of each gradient of the scan (the group's for dB and dC)
SSD_GRAD_HEAD_AXIS = {"dxh": 2, "dB": 2, "dC": 2, "ddt": 2, "dA": 0, "dh0": 1}


def per_head_rel(torch, a, ref, axis, scale=None):
    """For each index along ``axis``: the largest |a - ref| over its slice,
    over ``scale`` there (default: the largest |ref| there), or the plain
    difference where that is 0."""
    d = (a - ref).abs().movedim(axis, 0).reshape(a.shape[axis], -1).amax(1)
    m = ref.abs().movedim(axis, 0).reshape(a.shape[axis], -1).amax(1) if scale is None \
        else scale
    return torch.where(m > 0, d / torch.where(m > 0, m, 1), d)


def ssd_dA_terms(xh, dt, A, dxh, ddt):
    """Per (batch, position, head), the term dt dl that dA = -sum dt dl sums
    (dl the log-decay's gradient), from the inputs and the gradients dxh,
    ddt: x . dx = dt ddt_dir and ddt = ddt_dir - A dl, so dt dl = (x . dx -
    dt ddt) / A.  The sum of their magnitudes over (batch, position) is the
    size of a head's dA before its terms cancel: the scale its error is read
    against (a head's dA can cancel to 1e-3 of it)."""
    return ((xh * dxh).sum(-1) - dt * ddt) / A


def run_ssd_bwd_case(torch, K6, ops, ref, c, with_dh_final, seed):
    """K6's backward against ``ssd_chunked_bwd_ref`` on the same inputs (the
    chunk states the forward returns, as ``ops.ssd_chunked`` keeps them
    under grad).  fp32: each gradient within 1e-4 of its largest entry of
    the plain backward and of an fp64 evaluation of it (the per-tensor
    grads rule: the elementwise absolute-plus-relative form fails for fp32
    itself, the plain backward against fp64 included, where ddt = ddt_dir -
    A dl cancels; the share of elements outside it is reported for both),
    and in every head (every group for dB, dC) within 1e-4 of the head's
    largest fp64 entry, a head's dA within 1e-4 of the magnitudes of the
    terms it sums (``ssd_dA_terms``); the plain backward's per-head errors
    are reported beside the kernel's.  bf16: elementwise within 1e-2
    absolute plus relative of the plain backward of the same bf16 inputs.
    Every gradient finite, two calls bit for bit, the same bits through
    autograd (``ops.ssd_chunked`` under grad), whose forward gives the
    no-grad call's y and final state bit for bit, and the device kernels of
    ``ssd_bwd_device_kernels``, all ``ssd_bwd*``; with its time beside the
    plain backward's and the bound (no library call computes it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xh, Bm, Cm, dt, A, h0, chunk = (c[k] for k in ("xh", "B", "C", "dt", "A", "h0", "chunk"))
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dy = torch.randn((Bsz, T, H, P), generator=g, device="cuda")
    dhf = (0.5 * torch.randn((Bsz, H, P, N), generator=g, device="cuda")
           if with_dh_final else None)
    y, hfin, states = K6.ssd_chunked_cuda(xh, Bm, Cm, dt, A, h0, chunk)
    args = (xh, Bm, Cm, dt, A, h0, chunk, dy, dhf, states)
    got = K6.ssd_chunked_bwd_cuda(*args)
    again = K6.ssd_chunked_bwd_cuda(*args)
    torch.cuda.synchronize()
    names6 = ("dxh", "dB", "dC", "ddt", "dA", "dh0")
    pairs = [(n, a, b) for n, a, b in zip(names6, got, again) if a is not None]
    bitwise = all(torch.equal(a, b) for _, a, b in pairs)
    leaves = [t.detach().clone().requires_grad_(True) for t in (xh, Bm, Cm, dt, A)]
    hl = None if h0 is None else h0.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        ya, ha = ops.ssd_chunked(*leaves, hl, chunk)
        loss = (ya * dy).sum() + ((ha * dhf).sum() if dhf is not None else 0)
        auto = torch.autograd.grad(loss, leaves + ([hl] if hl is not None else []))
    auto_same = all(torch.equal(a, b) for a, b in zip(auto, got))
    fwd_same = bool(torch.equal(ya, y)) and bool(torch.equal(ha, hfin))
    want = ref.ssd_chunked_bwd_ref(xh, Bm, Cm, dt, A, h0, chunk, dy, dhf)
    ok = all((gv is None) == (wv is None) for gv, wv in zip(got, want))
    present = [(n, gv, wv) for n, gv, wv in zip(names6, got, want) if wv is not None]
    errs = {n: float((gv.float() - wv.float()).abs().max()) for n, gv, wv in present}
    row_extra = {}
    if c["dtype"] == "float32":
        tol = GRAD_TOL
        f64 = lambda t: None if t is None else t.double()  # noqa: E731
        exact = ref.ssd_chunked_bwd_ref(*(f64(t) for t in (xh, Bm, Cm, dt, A, h0)), chunk,
                                        f64(dy), f64(dhf))
        rel32, rel64, plain64, share, plain_share, head, heads_out = ({} for _ in range(7))
        for (n, gv, wv), ev in zip(present, [e for e in exact if e is not None]):
            gd, wd = gv.double(), wv.double()
            rel32[n] = float((gd - wd).abs().max() / wd.abs().max())
            rel64[n] = float((gd - ev).abs().max() / ev.abs().max())
            plain64[n] = float((wd - ev).abs().max() / ev.abs().max())
            share[n] = float(((gd - wd).abs() > tol + tol * wd.abs()).double().mean())
            plain_share[n] = float(((wd - ev).abs() > tol + tol * ev.abs()).double().mean())
            # per head (per group for dB, dC): a fault confined to the weak heads
            # stays under 1e-4 of the tensor's max, not under 1e-4 of its head's;
            # a head's dA is read against the size of its terms
            scale = None if n != "dA" else ssd_dA_terms(
                xh.double(), dt.double(), A.double(), exact[0], exact[3]).abs().sum((0, 1))
            k_h, p_h = (per_head_rel(torch, t, ev, SSD_GRAD_HEAD_AXIS[n], scale)
                        for t in (gd, wd))
            w = int(torch.argmax(k_h))
            head[n] = dict(head=w, rel_err_fp64=float(k_h[w]), plain_rel_err_fp64=float(p_h[w]),
                           plain_worst=float(p_h.max()))
            heads_out[n] = [int((k_h > tol).sum()), int((p_h > tol).sum()), k_h.numel()]
            ok &= rel32[n] <= tol and rel64[n] <= tol and not bool((k_h > tol).any())
        row_extra = dict(grad_rel_err=rel32, grad_rel_err_fp64=rel64, plain_rel_err_fp64=plain64,
                         worst_head=head, heads_out_kernel_plain_of=heads_out,
                         elementwise_outside_share=share,
                         plain_fp64_elementwise_outside_share=plain_share)
    else:
        tol = TOL["bfloat16"]
        for n, gv, wv in present:
            ok &= within(torch, gv, wv, tol)[1]
    finite = all(bool(torch.isfinite(t).all()) for t in got if t is not None)
    Q = ref.ssd_chunk_len(T, chunk)
    plan = K6.ssd_bwd_plan(Bsz, T, H, G, P, N, Q, h0 is not None)
    names = [kernel_name(n) for n in device_kernels(torch, K6.ssd_chunked_bwd_cuda, args,
                                                    expect=plan["device_kernels"])]
    kernels_ok = (len(names) == plan["device_kernels"]
                  and all(n.startswith("ssd_bwd") for n in names))
    row = dict(case=c["name"], dtype=c["dtype"], shape=c["shape"]
               + (" dh_final" if with_dh_final else ""), max_abs_err=max(errs.values()),
               grad_max_abs_err=errs, tol=tol, **row_extra, finite=finite,
               bitwise_repeatable=bitwise,
               autograd_bitwise=auto_same, autograd_fwd_bitwise=fwd_same,
               plan={k: plan[k] for k in ("tiles", "heads_per_block", "key_blocks",
                                          "query_blocks", "s_blocks", "state_blocks")},
               device_kernels=len(names), kernel_names=names,
               ok=ok and finite and bitwise and auto_same and fwd_same and kernels_ok)
    case_bytes = sum(t.numel() * t.element_size() for t in args[:6] + args[7:]
                     if isinstance(t, torch.Tensor))
    copies = min(8, max(2, math.ceil(2 * 50e6 / case_bytes)))
    sets = [tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in args)
            for _ in range(copies)]
    row["ms"] = device_ms(torch, K6.ssd_chunked_bwd_cuda, sets, iters=10)
    row["plain_ms"] = device_ms(torch, lambda *a: ref.ssd_chunked_bwd_ref(*a[:9]), sets,
                                iters=3)
    row["library_ms"] = None
    b = ssd_bwd_bound(torch, ref, c, dhf)
    row.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"], bound_simt_ms=b["bound_simt_ms"])
    del sets
    return row


SSD_BWD_CASES = [   # (name, make_ssd_case arguments, a dh_final): mamba2-1.3b's heads
    ("train_b4_t512", dict(B=4, T=512), False),             # the trainer's call: 2 chunks
    ("t2048_8chunks", dict(B=1, T=2048), False),
    ("t300_q150", dict(B=2, T=300), False),
    ("t256_one_chunk", dict(B=2, T=256), False),            # three device kernels
    ("g8_t512", dict(B=1, T=512, G=8), False),              # 8 heads a group
    ("smoke_widths_t24", dict(B=2, T=24, H=8, P=32, N=16, chunk=8, h0=True), True),
    ("strong_decay_t512", dict(B=2, T=512, strong=True), False),
    ("h0_dh_final_t512", dict(B=2, T=512, h0=True), True),
    ("h0_dh_final_t256", dict(B=2, T=256, h0=True), True),  # one chunk with a state
    ("p128_n64_t512", dict(B=1, T=512, H=8, P=128, N=64, h0=True), True),  # the wide build
]


def phase_ssd_bwd_kernels(torch, K6, ops, ref):
    rows = []
    for i, (name, kw, dhf) in enumerate(SSD_BWD_CASES):
        for dtype in ("float32", "bfloat16"):
            c = make_ssd_case(torch, f"ssd_bwd_{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                              dtype=dtype, seed=500 + i, **kw)
            r = run_ssd_bwd_case(torch, K6, ops, ref, c, dhf, seed=600 + i)
            rows.append(r)
            print("  " + json.dumps(r), flush=True)
            del c
    bad = [r["case"] for r in rows if not r["ok"]]
    check(not bad, "K6's backward disagrees with its plain backward, is not finite, differs "
          "between two calls or from autograd's, or issues other device kernels than its "
          f"rule: {bad}")
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


def profile_step(torch, eng, tp, dp, name, state, s, steps=4, keep=None, host=True):
    """One engine step at length ``s`` from ``state``: the wall time of an
    unprofiled run of ``steps`` steps against the device time that
    ``torch.profiler`` sees over as many more, with the kernels' shares and
    (``host``) the host's most expensive ops; ``host=False`` traces the
    device alone, which costs the profiler a fraction of the time.  The
    state after the steps is appended to ``keep`` when given."""
    from torch.profiler import ProfilerActivity

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
    acts = [ProfilerActivity.CPU] if host else []

    def body():
        nonlocal state
        for _ in range(steps):
            state, _ = eng.step(tp, dp, state, s)
    prof, takes, lost = whole_profile(torch, body, acts + [ProfilerActivity.CUDA],
                                      serving_kinds())
    dev = kernels(prof)
    busy_ms = sum(dev.values())
    top_dev = sorted(dev.items(), key=lambda kv: kv[1], reverse=True)[:6]
    top_cpu = (sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:6] if host else [])
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
                     for e in top_cpu},
        profile_takes=takes, profile_lost=lost)
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
    from torch.profiler import ProfilerActivity
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

        def rewind():   # a retake profiles the same chunks again
            nonlocal state, cur
            state = eng.retire_slot(state, slot)
            cur = 0
            for _ in range(1 + steps):
                one()
        prof, takes, lost = whole_profile(torch, lambda: [one() for _ in range(steps)],
                                          [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                          serving_kinds(), reset=rewind)
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in dev) / 1e3 / steps
        k3 = [e for e in dev if "paged_verify_kernel" in e.name]
        row = dict(wall_ms=wall_ms, device_busy_ms=busy,
                   idle_share=max(0.0, 1.0 - busy / wall_ms), device_kernels=len(dev) / steps,
                   k3_ms=sum(e.device_time_total for e in k3) / 1e3 / steps,
                   k3_device_kernels=len(k3) / steps, profile_takes=takes,
                   profile_lost=lost)
        print("  " + json.dumps({"step": f"paged_b16_s0_chunk{chunk}_{name}", **row}),
              flush=True)
        out[name] = row
    eng.retire_slot(state, slot)
    return out


def profile_prefill(torch, np, model, params, vocab, T=256, n=213, calls=3):
    """One target prefill at B = 1 of a prompt of ``n`` tokens padded to
    ``T`` (the continuous run's largest bucket), bf16: its wall time against
    the device time ``torch.profiler`` sees, and K6's share of it."""
    from torch.profiler import ProfilerActivity
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
    prof, takes, lost = whole_profile(torch, lambda: [run() for _ in range(calls)],
                                      [ProfilerActivity.CUDA], serving_kinds())
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e3 / calls
    k6 = sum(e.device_time_total for e in dev
             if kernel_name(e.name).startswith("ssd_")) / 1e3 / calls
    k6_kernels = sum(1 for e in dev if kernel_name(e.name).startswith("ssd_")) / calls
    row = dict(prefill=f"B1 T{T} prompt {n}, bf16", wall_ms=wall_ms, device_busy_ms=busy,
               k6_ms=k6, k6_share=k6 / busy if busy else None, k6_device_kernels=k6_kernels,
               device_kernels=len(dev) / calls, profile_takes=takes, profile_lost=lost)
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
    """The scheduling decisions of a StepTrace, chunk events and prefix-cache
    hits included, without its clock."""
    return [(t.occupancy, t.s, t.rids, t.committed, t.admitted, t.preempted, t.done_rids,
             t.chunked, t.cache_hits) for t in trace]


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


ENGINE_CALLS = ("step_with_chunk", "step", "flush_chunk", "prefill_chunk_into",
                "prefill_into", "attach_prefix")


def engine_calls(eng):
    """Count, and time on the host clock, the engine's mixed steps, plain
    steps, flushes and chunk forwards run at feed time, by wrapping its
    methods on the instance (``release_calls`` takes them off).  A step ends
    in its ``.cpu()`` read of the counts, so its host time covers its
    device work.  Also the target rows each prefill and chunk feeds
    (``rows_fed``: a whole prefill feeds ``prompt_len - 1``) and each
    admission's ``(feed length, cached prefix)`` (a whole prefill, a first
    chunk, or a prefix-cache attach)."""
    import inspect
    rec = {"step_with_chunk": [], "step": [], "flush_chunk": [], "final_chunks": 0,
           "deferred_chunks": 0, "rows_fed": 0, "admissions": []}
    for name in ENGINE_CALLS:
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            if kw.get("warm"):
                return _fn(*a, **kw)
            arg = inspect.signature(_fn).bind(*a, **kw).arguments
            if _name == "prefill_into":
                rec["rows_fed"] += arg["prompt_len"] - 1
                rec["admissions"].append((arg["prompt_len"], 0))
            elif _name == "attach_prefix":
                rec["admissions"].append((arg["total_len"], arg["n_prefix"]))
            elif _name == "prefill_chunk_into":
                rec["deferred_chunks" if kw.get("defer") else "final_chunks"] += 1
                rec["rows_fed"] += arg["n"]
                if arg["start"] == 0:
                    rec["admissions"].append((arg["total_len"], 0))
            if _name not in rec:
                return _fn(*a, **kw)
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            rec[_name].append(time.perf_counter() - t0)
            return out
        setattr(eng, name, wrapped)
    return rec


def release_calls(eng):
    for name in ENGINE_CALLS:
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


def paged_slot_rows(torch, st, slot, plen):
    """K, V and pos of a slot's ``plen - 1`` prefilled target rows through
    its table, and its draft ring's ``plen - 2`` rows of K and V, in fp32."""
    ids = torch.tensor(st.paged.table(slot), device="cuda")
    out = {n: st.tcache[n][:, ids].flatten(1, 2)[:, :plen - 1].float() for n in ("k", "v")}
    out.update({"draft_" + n: st.dcache[n][:, slot, :plen - 2].float() for n in ("k", "v")})
    return out, st.tcache["pos"][ids].flatten()[:plen - 1]


def first_step_logits(torch, m, e, tparams, st, vocab):
    """The target's logits of every slot's first decode step (s = 0: the
    last prompt token at position plen - 1), through K3 as the step runs
    it, in fp32 ``[B, vocab]``."""
    cu = torch.from_numpy(m.host_cu_blocks(st.paged.device_tables())).cuda()
    lg, _ = e.target.decode_step(tparams, st.last2[:, 1:], st.tcache, st.seq_lens, cu)
    return lg[:, -1, :vocab].float()


def rel_rms_over(x, want, dims):
    return ((x - want) ** 2).mean(dims).sqrt() / (want ** 2).mean(dims).sqrt()


def route_against_whole(torch, np, got, whole, fp32_rows, logits, tokens, layer0_gated=True):
    """One bf16 prefill route against the whole route (``prefill_into``),
    with the whole route in fp32 as the reference: ``got`` and ``whole``
    are ``(paged_slot_rows, ...)`` pairs, ``logits`` and ``tokens`` the
    (route, whole, fp32) first-step logits and (route, whole) greedy
    tokens.  ``rows_ok``: positions equal, layer 0's K/V rows equal
    (unless ``layer0_gated`` is false), and at every layer the rows no
    further from fp32 than the whole route's, 1.5x in relative RMS, over
    the layer and in its worst row; ``logits_ok`` the same for the logits.
    The elementwise 1e-2 comparison and the greedy tokens are reported."""
    ratio, tol = BF16_GRAD_RMS_RATIO, TOL["bfloat16"]
    (rc, pc), (rw, pw) = got, whole
    ok = bool(torch.equal(pc, pw))
    stats = {}
    for name in rw:
        w, c, f = rw[name], rc[name], fp32_rows[name]
        layer_w, layer_c = rel_rms_over(w, f, (1, 2, 3)), rel_rms_over(c, f, (1, 2, 3))
        row_w, row_c = (rel_rms_over(x, f, (2, 3)).max(1).values for x in (w, c))
        err = (c - w).abs()
        beyond = (err > tol + tol * w.abs()).flatten(1).float().mean(1)
        layer0 = bool(torch.equal(c[0], w[0]))
        ok &= (layer0 or not layer0_gated) and bool((layer_c <= ratio * layer_w).all()) \
            and bool((row_c <= ratio * row_w).all())
        stats[name] = dict(layer0_equal=layer0,
                           rel_rms_vs_fp32_deepest=[float(layer_w[-1]), float(layer_c[-1])],
                           worst_layer_ratio=float((layer_c / layer_w).max()),
                           worst_row_ratio=float((row_c / row_w).max()),
                           max_abs_err_vs_whole=float(err.max()),
                           beyond_1e2_share_deepest=float(beyond[-1]),
                           beyond_1e2_share_layer1=float(beyond[min(1, len(beyond) - 1)]))
    lc, lw, lf = logits
    lerr = (lc - lw).abs()
    same = tokens[1] == tokens[0]
    return dict(
        rows_ok=ok, positions_equal=bool(torch.equal(pc, pw)), rows=stats,
        logits_ok=bool(rel_rms_over(lc, lf, 0) <= ratio * rel_rms_over(lw, lf, 0)),
        logits_rel_rms_vs_fp32=[float(rel_rms_over(lw, lf, 0)), float(rel_rms_over(lc, lf, 0))],
        logits_max_abs_err_vs_whole=float(lerr.max()),
        logits_beyond_1e2_share=float((lerr > tol + tol * lw.abs()).float().mean()),
        first_token_equal=bool(lw.argmax() == lc.argmax()),
        greedy_tokens_equal=int(same.sum()), greedy_tokens=int(same.size),
        first_divergence=None if same.all() else int(np.argmin(same)))


def greedy_tokens(eng, tp, dp, st, slots):
    """Step ``st`` at s = 0 until every slot of ``slots`` is done; their
    generated tokens."""
    for _ in range(eng.max_new + 2):
        st, _ = eng.step(tp, dp, st, 0)
        if bool(st.done[list(slots)].all().cpu()):
            break
    return {slot: st.out[slot, :eng.max_new].cpu().numpy() for slot in slots}


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

    states = {r: fill(eng, tp, dp, r) for r in slot_of}
    got = {r: paged_slot_rows(torch, st, slot_of[r], plen) for r, st in states.items()}
    lg = {r: first_step_logits(torch, m, eng, tp, st, vocab)[slot_of[r]]
          for r, st in states.items()}
    e32 = m.SpecDecodeEngine(eng.tcfg, eng.dcfg, max_new=eng.max_new, dtype=torch.float32,
                             device="cuda")
    tp32, dp32 = (tree_map(lambda t: t.float(), p) for p in (tp, dp))
    ref = fill(e32, tp32, dp32, "whole")
    rf, _ = paged_slot_rows(torch, ref, 0, plen)
    lf = first_step_logits(torch, m, e32, tp32, ref, vocab)[0]
    del e32, tp32, dp32, ref
    torch.cuda.empty_cache()
    ratio = BF16_GRAD_RMS_RATIO
    line = dict(prompt=plen, chunk=chunk)
    tokens = {r: greedy_tokens(eng, tp, dp, st, [slot_of[r]])[slot_of[r]]
              for r, st in states.items()}
    for route in ("chunked", "mixed"):
        line[route] = route_against_whole(
            torch, np, got[route], got["whole"], rf, (lg[route], lg["whole"], lf),
            (tokens["whole"], tokens[route]), layer0_gated=route != "mixed")
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
# phase 6d: the prefix cache on the continuous main path

PREFIX_SYSTEM = 256            # tokens of the system prompt every request shares


def prefix_requests(np, Request, vocab, n=24, tails=(16, 64), interval=0.05, seed=37):
    """Phase 6d's templated trace: ``n`` requests that share one 256-token
    system prompt, each with a unique tail of ``tails`` tokens and 32 new
    tokens, arriving every ``interval`` seconds.  Chosen with a CPU
    ``SimStepBackend`` run of this trace on phase 6b's pool (16 slots, cap
    512, 144 blocks of 16; 35 ms a step, 46 ms a prefill, 45 ms a chunk,
    nothing accepted): cold, 2 preemptions at s_cap 0-6 and intervals
    0.02-0.1 s; with the cache, 23 of 24 requests hit under the default
    admission, 22 under ``PrefillBudgetAdmit(128, chunk=64)``, and nothing
    is evicted (the cache never outgrows the free blocks), so eviction is
    reported, not gated."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(tails[0], tails[1] + 1))).astype(np.int32)
        toks = np.concatenate([system, tail])
        out.append(Request(rid=i, arrival=interval * i, tokens=toks, prompt_len=len(toks),
                           max_new=32))
    return out


def mean_ms(xs):
    return 1e3 * sum(xs) / max(len(xs), 1)


def prefix_serve_run(torch, np, m, eng, tp, dp, reqs, lut, geo, counters, cache, budget):
    """One ``serve_continuous_live`` run of phase 6d's trace through an
    explicit backend (``prefix_cache=cache``; chunked under
    ``PrefillBudgetAdmit(**budget)`` when ``budget`` is given): its serving
    numbers, hits, evictions, launches, the engine's steps and chunk
    forwards and the target rows fed (``engine_calls``), the StepTrace's
    replay on a ``SimStepBackend`` with the same cache, the pool's
    invariants, and the mean host seconds (fenced) of an attach, a
    zero-suffix commit, a whole prefill and a chunk, as the backend returns
    them."""
    import copy
    ctrl = lambda: m.AdaptiveController(lut=m.SpeculationLUT(lut))
    policy = lambda: m.PrefillBudgetAdmit(**budget) if budget else None
    backend = m.ContinuousEngineBackend(eng, tp, dp, warm_s=sorted(set(lut.values())),
                                        prefix_cache=cache, **geo)
    host = {"attach": [], "commit_attached": [], "prefill": [], "prefill_chunk": []}
    for name in host:
        def timed(*a, _fn=getattr(backend, name), _name=name, **kw):
            dt = _fn(*a, **kw)
            host[_name].append(dt)
            return dt
        setattr(backend, name, timed)
    for c in counters:
        c.launches = 0
    calls = engine_calls(eng)
    t0 = time.perf_counter()
    try:
        res = m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp, ctrl(), backend=backend,
                                      policy=policy())
        torch.cuda.synchronize()
    finally:
        release_calls(eng)
    wall = time.perf_counter() - t0
    launches = dict(k1=m.K1.KERNEL.launches, k2=m.K23.DENSE.launches,
                    k3=m.K23.RAGGED.launches, k5=m.K5.FWD.launches,
                    plain=(m.ops.PLAIN.launches + m.paged.PLAIN.launches
                           + m.ops.PLAIN_RMSNORM.launches))
    hits = [h for t in res.trace for h in t.cache_hits]
    kv = backend.kv
    try:
        kv.pool.check_invariants()
        invariants = True
    except AssertionError:
        invariants = False
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    return dict(
        finished=len(done), **serve_line(m, res, wall), hits=len(hits),
        hit_requests=len({rid for rid, _ in hits}), hit_tokens=sum(p for _, p in hits),
        evicted_blocks=kv.evicted_total, cached_blocks_at_end=kv.cached_blocks,
        sim_replay_equal=replays_equal(np, m, res, reqs, ctrl(), policy(), geo["capacity"],
                                       max_context=geo["cache_len"],
                                       block_size=geo["block_size"],
                                       num_blocks=geo["num_blocks"], prefix_cache=cache),
        pool_invariants=invariants, launches=launches,
        engine_steps=len(calls["step"]), chunk_forwards=calls["final_chunks"],
        k3_expected=eng.tcfg.n_layers * (len(calls["step"]) + calls["final_chunks"]),
        admissions=len(calls["admissions"]),
        trace_admissions=sum(len(t.admitted) for t in res.trace),
        attach_prefixes_equal_hits=[p for _, p in calls["admissions"] if p]
        == [p for _, p in hits],
        rows_fed=calls["rows_fed"],
        rows_expected=sum(max(0, n - 1 - p) for n, p in calls["admissions"]),
        host_ms={k: mean_ms(v) for k, v in host.items()},
        host_calls={k: len(v) for k, v in host.items()})


def prefix_rows_check(torch, np, m, eng, tp, dp, vocab):
    """Phase 6d's numerics in bf16, with phase 6c's rule.  A donor prompt
    (the 256-token system prompt and a 40-token tail) is prefilled whole
    and published into a ``PrefixCache``, then retired.  (a) A hit: the
    system prompt and a 48-token tail, attached after the 16 shared blocks
    (``attach_prefix``), its 47-row suffix fed as one chunk from row 256
    (K3 over the shared rows).  (b) A zero-suffix hit: the system prompt
    alone, 256 of 256 tokens cached, so ``commit_attached`` copies the
    shared block of row 255 on write.  Each is held against
    ``prefill_into`` of the same prompt in bf16, with that route in fp32
    (the bf16 weights cast) as the reference (``route_against_whole``:
    positions equal, layer 0's K/V rows equal, every layer's rows through
    the slot's table and the first step's logits no further from fp32 than
    the whole route's, 1.5x in relative RMS).  For (b) also: the copy's
    rows equal the source block's, and the source block is bit for bit
    unchanged after the slot's first decode step.  The greedy tokens are
    reported."""
    rng = np.random.default_rng(43)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).astype(np.int32)
    donor = np.concatenate([system, rng.integers(0, vocab, 40).astype(np.int32)])
    prompts = {"hit": np.concatenate([system, rng.integers(0, vocab, 48).astype(np.int32)]),
               "zero_suffix": system}
    slot_of = {"hit": 1, "zero_suffix": 2}

    def padded(p):
        toks = np.ones((512,), np.int32)
        toks[:len(p)] = p
        return toks

    def whole(e, tparams, dparams, p):
        st = e.init_slots(1, 512, block_size=16)
        return e.prefill_into(tparams, dparams, st, 0, padded(p), len(p), 512)

    st = eng.init_slots(3, 512, block_size=16)
    pk = st.paged
    cache = m.PrefixCache(pk.pool)
    pk.attach_cache(cache)
    st = eng.prefill_into(tp, dp, st, 0, padded(donor), len(donor), 512)
    n_ins = (len(donor) - 1) // 16
    cache.insert(donor[:n_ins * 16], pk.table(0)[:n_ins])
    st = eng.retire_slot(st, 0)
    n_prefix = {}
    for route, p in prompts.items():
        blocks = cache.lock(p)
        n_prefix[route] = P = len(blocks) * 16
        pk.attach(slot_of[route], blocks, P)
        cache.unlock(blocks)
        st = eng.attach_prefix(dp, st, slot_of[route], padded(p), P, len(p))
        if route == "hit":
            n = len(p) - 1 - P
            toks = np.ones((64,), np.int32)
            toks[:n] = p[P:P + n]
            st = eng.prefill_chunk_into(tp, dp, st, slot_of[route], toks, P, n, len(p),
                                        last2=p[-2:])
        else:
            src = pk.table(slot_of[route])[-1]
            snap = {k: (st.tcache[k][src] if k == "pos" else st.tcache[k][:, src]).clone()
                    for k in ("k", "v", "pos")}
            st = eng.commit_attached(st, slot_of[route], len(p), p[-2:])
            dst = pk.table(slot_of[route])[-1]
            copy_equal = dst != src and all(torch.equal(
                st.tcache[k][dst] if k == "pos" else st.tcache[k][:, dst], snap[k])
                for k in snap)
    got = {r: paged_slot_rows(torch, st, slot_of[r], len(p)) for r, p in prompts.items()}
    lg_cache = first_step_logits(torch, m, eng, tp, st, vocab)
    wholes = {r: whole(eng, tp, dp, p) for r, p in prompts.items()}
    gw = {r: paged_slot_rows(torch, w, 0, len(prompts[r])) for r, w in wholes.items()}
    lw = {r: first_step_logits(torch, m, eng, tp, w, vocab)[0] for r, w in wholes.items()}
    e32 = m.SpecDecodeEngine(eng.tcfg, eng.dcfg, max_new=eng.max_new, dtype=torch.float32,
                             device="cuda")
    tp32, dp32 = (tree_map(lambda t: t.float(), p) for p in (tp, dp))
    rf, lf = {}, {}
    for r, p in prompts.items():
        ref = whole(e32, tp32, dp32, p)
        rf[r], _ = paged_slot_rows(torch, ref, 0, len(p))
        lf[r] = first_step_logits(torch, m, e32, tp32, ref, vocab)[0]
        del ref
    del e32, tp32, dp32
    torch.cuda.empty_cache()
    # the slots' first decode step, then the source block of row 255
    st, _ = eng.step(tp, dp, st, 0)
    source_unchanged = all(torch.equal(
        st.tcache[k][src] if k == "pos" else st.tcache[k][:, src], snap[k]) for k in snap)
    tokens = greedy_tokens(eng, tp, dp, st, list(slot_of.values()))
    line = dict(system=PREFIX_SYSTEM, n_prefix=n_prefix,
                copy_rows_equal_source=copy_equal, source_unchanged_after_step=source_unchanged,
                source_still_indexed=cache.match(prompts["zero_suffix"])[-1] == src)
    for r, p in prompts.items():
        wt = greedy_tokens(eng, tp, dp, wholes[r], [0])[0]
        line[r] = route_against_whole(torch, np, got[r], gw[r], rf[r],
                                      (lg_cache[slot_of[r]], lw[r], lf[r]),
                                      (wt, tokens[slot_of[r]]))
    print("  prefix-cache routes vs whole prefill (bf16): " + json.dumps(line), flush=True)
    ratio = BF16_GRAD_RMS_RATIO
    for r in prompts:
        check(line[r]["rows_ok"], f"the {r} route's rows differ from the whole route's beyond "
                                  f"its own bf16 error: {line[r]['rows']}")
        check(line[r]["logits_ok"], f"the first step's logits of the {r} route are further "
                                    f"from fp32 than {ratio}x the whole route's")
    check(n_prefix == {"hit": PREFIX_SYSTEM, "zero_suffix": PREFIX_SYSTEM},
          f"the routes did not attach the 256 shared rows: {n_prefix}")
    check(copy_equal, "the copy-on-write copy's rows differ from its source block's")
    check(source_unchanged, "the shared source block changed under the slot's first step")
    return line


def phase_prefix_serve(torch, np, R, m, lut_table):
    """bf16, full depth: phase 6b's pair and pool (16 slots, cap 512, 144
    blocks of 16) with phase 4's LUT serving phase 6d's templated trace
    (``prefix_requests``) three times: cold, with ``prefix_cache=True``
    under the default admission, and with the cache under
    ``PrefillBudgetAdmit(128, chunk=64)`` (partial hits fed as suffix
    chunks).  Gated: every request finishes; the cold run preempts; each
    cache run hits on at least 20 of the 24 requests; every StepTrace,
    ``cache_hits`` included, equals its ``SimStepBackend`` replay (with the
    cache when the run had it); the pool's invariants hold after each run;
    K3 runs once per layer in every step and every chunk forward, K1 and K5
    run, no plain version does; each admission's attach prefix is its
    StepTrace hit, and the target rows the cache runs feed through
    prefills and chunks equal the sum over admissions of the feed length
    less its cached prefix, below the cold run's.  Then the numerics
    (``prefix_rows_check``)."""
    bf16 = torch.bfloat16
    tcfg, dcfg = R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b")
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    lut = {int(b): int(v) for b, v in lut_table.items()}
    reqs = prefix_requests(np, m.Request, tcfg.vocab_size)
    geo = dict(capacity=16, cache_len=512, block_size=16, num_blocks=144)
    counters = (m.K1.KERNEL, m.K23.DENSE, m.K23.RAGGED, m.K5.FWD, m.ops.PLAIN, m.paged.PLAIN,
                m.ops.PLAIN_RMSNORM)
    eng.load_kernels(paged=True)
    torch.cuda.synchronize()
    runs = {name: prefix_serve_run(torch, np, m, eng, tp, dp, reqs, lut, geo, counters,
                                   cache, budget)
            for name, cache, budget in (("cold", False, None), ("cache", True, None),
                                        ("cache_chunked", True,
                                         dict(token_budget=128, chunk=64)))}
    line = dict(requests=len(reqs), system=PREFIX_SYSTEM, **runs)
    print("  " + json.dumps(line), flush=True)
    for name, r in runs.items():
        check(r["finished"] == len(reqs), f"{name}: {len(reqs) - r['finished']} requests did "
                                          f"not finish")
        check(r["sim_replay_equal"], f"{name}: the StepTrace differs from its replay")
        check(r["pool_invariants"], f"{name}: the block pool's invariants broke")
        check(r["launches"]["k3"] == r["k3_expected"],
              f"{name}: K3 ran {r['launches']['k3']} times, not 32 x (steps + chunk "
              f"forwards) = {r['k3_expected']}")
        check(r["launches"]["k1"] > 0 and r["launches"]["k5"] > 0, f"{name}: K1 or K5 never ran")
        check(r["launches"]["plain"] == 0, f"{name}: a plain version ran on the card")
        check(r["admissions"] == r["trace_admissions"] and r["attach_prefixes_equal_hits"],
              f"{name}: the engine's admissions differ from the StepTrace's")
        check(r["rows_fed"] == r["rows_expected"],
              f"{name}: fed {r['rows_fed']} target rows, not {r['rows_expected']}")
    check(runs["cold"]["preemptions"] > 0, "the cold run never preempted")
    for name in ("cache", "cache_chunked"):
        check(runs[name]["hit_requests"] >= 20,
              f"{name}: only {runs[name]['hit_requests']} of 24 requests hit the cache")
        check(runs[name]["rows_fed"] < runs["cold"]["rows_fed"],
              f"{name}: fed {runs[name]['rows_fed']} target rows, not fewer than the cold "
              f"run's {runs['cold']['rows_fed']}")
    line["rows"] = prefix_rows_check(torch, np, m, eng, tp, dp, tcfg.vocab_size)
    return line


# ---------------------------------------------------------------------------
# phase 6e: the int8 KV cache (kv_quant) on the continuous main path

Q8_TOL = dict(logits=2e-3,            # card vs CPU, fp32 on both sides: phase 3's
              scale_rel_layer0=1e-6,   # a scale is its row's largest |value| / 127
              scale_rel=2e-3,          # deeper layers: inputs moved as the logits are
              moved_share=1e-3)        # codes a round-half tie may move by 1
# a route's greedy token may differ from solo's only where solo's top-2
# logit margin is below twice the logits' deviation that moved codes cause
Q8_TIE_MARGIN = 2 * Q8_TOL["logits"]


def q8_blocks(cfg, bf16_blocks, bs=16):
    """int8 blocks of ``bs`` rows (codes plus bf16 scales) in the bytes of
    ``bf16_blocks`` bf16 blocks, the positions (4 bytes a row either way)
    left out: 283 for OPT-6.7B's 144."""
    a = cfg.attn
    bf16 = 2 * bs * a.n_kv_heads * a.head_dim * 2
    int8 = 2 * bs * a.n_kv_heads * (a.head_dim + 2)
    return bf16_blocks * bf16 // int8


def row_leaves(cache):
    """A cache's per-row leaves (k, v and an int8 cache's scales)."""
    return {n: t for n, t in cache.items() if n not in ("pos", "bt")}


def codes_against(torch, got, want):
    """Two int8 caches' row leaves (same shapes ``[nL, ...]``, on the CPU):
    the largest code distance, how many codes moved and their share, and
    each layer's largest relative distance of the nonzero scales.  Layer 0
    sees equal inputs on both sides, up to the rounding of its products;
    a code that a round-half tie moves there moves a K/V value by a whole
    scale step, and with it every later layer's inputs."""
    d = {n: (got[n].to(torch.int16) - want[n].to(torch.int16)).abs() for n in ("k", "v")}
    nL = got["k"].shape[0]
    rel = [max(float(((got[n][i].float() - want[n][i].float()).abs()
                      / want[n][i].float().clamp_min(1e-30))[want[n][i] != 0].max())
               for n in ("k_scale", "v_scale")) for i in range(nL)]
    moved = sum(int((x > 0).sum()) for x in d.values())
    return dict(max_code_distance=max(int(x.max()) for x in d.values()), moved=moved,
                moved_share=moved / sum(x.numel() for x in d.values()),
                scale_max_rel_by_layer=rel)


def codes_ok(c):
    rel = c["scale_max_rel_by_layer"]
    return (c["max_code_distance"] <= 1 and rel[0] <= Q8_TOL["scale_rel_layer0"]
            and max(rel) <= Q8_TOL["scale_rel"]
            and (c["moved"] <= 1 or c["moved_share"] <= Q8_TOL["moved_share"]))


def solo_margin(torch, np, model, params, r, tokens, t):
    """The top-2 logit margin of ``model``'s greedy choice of generated
    token ``t`` of request ``r`` (``tokens`` its solo stream), from a
    prefill of the prompt and the first ``t`` tokens."""
    ctx = np.concatenate([r.tokens[:r.prompt_len], tokens[:t]]).astype(np.int64)
    lg, _ = greedy_logits(torch, model, params, torch.from_numpy(ctx[None]),
                          torch.tensor([len(ctx)], dtype=torch.int32), 0,
                          -(-len(ctx) // 64) * 64, "cuda")
    return top2_margin(torch, lg)


def kvq_prefix_requests(np, Request, vocab, system=32, seed=53):
    """Six requests sharing a 32-token system prompt (two blocks of 16):
    one with a 6-token tail, the system prompt alone (a zero-suffix hit
    whose last feed row lies in a cached block, so ``commit_attached``
    copies it), the system prompt and one token (a zero-suffix hit without
    a copy) and three with 3-12-token tails; all arrive at 0, 24 new
    tokens each."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, system).astype(np.int32)
    tails = [6, 0, 1, 3, 9, 12]
    out = []
    for i, n in enumerate(tails):
        toks = np.concatenate([sys_p, rng.integers(0, vocab, n).astype(np.int32)])
        out.append(Request(rid=i, arrival=0.0, tokens=toks, prompt_len=len(toks), max_new=24))
    return out


def kvq_parity(torch, np, R, m, tree_to):
    """fp32, the full-width pair cut to 2 layers, both ``kv_quant``:
    phase 6a's trace served paged (12 blocks, preempting), contiguous,
    paged chunked and paged mixed, a shared-prompt trace served paged with
    the prefix cache (hits and zero-suffix admissions, one through a
    copy-on-write), and every request's solo ``generate``: equal tokens,
    but where the solo stream's top-2 margin at the first differing token
    is below ``Q8_TIE_MARGIN`` (the routes' products run on other numbers
    of rows, so a round-half tie can move a code by one step on one route
    and not on the other); speculative (s = 3) == greedy; each StepTrace
    equals its ``SimStepBackend`` replay; the paged ``decode_step`` gives
    the same logits through K2 and K3; and the card against the CPU port
    on the same inputs (a ring prefill and verify, a paged verify):
    logits, codes and scales within ``Q8_TOL``."""
    import copy
    f32 = torch.float32
    tcfg = R.get_config("opt-6.7b").with_(n_layers=2, kv_quant=True)
    dcfg = R.get_draft_config("opt-6.7b").with_(n_layers=2, kv_quant=True)
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=24, dtype=f32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    tp = eng.target.init(gen, f32, "cuda")
    dp = eng.draft.init(gen, f32, "cuda")
    vocab = tcfg.vocab_size
    reqs = continuous_requests(np, m.Request, vocab, 12, (8, 40), 24, 0.0, 21)
    preqs = kvq_prefix_requests(np, m.Request, vocab)
    ctrl = m.fixed_controller(3)
    geo = dict(capacity=8, cache_len=96)
    paged_geo = dict(block_size=16, num_blocks=12)
    budget = dict(token_budget=16, chunk=8)
    plan = (("paged", reqs, paged_geo, False), ("contiguous", reqs, {}, False),
            ("paged_chunked", reqs, paged_geo, True),
            ("paged_mixed", reqs, dict(paged_geo, mixed_launch=True), True),
            ("paged_prefix_cache", preqs, dict(block_size=16, num_blocks=32,
                                                prefix_cache=True), False))
    runs = {}
    for name, trace, kw, chunked in plan:
        be = m.ContinuousEngineBackend(eng, tp, dp, collect_outputs=True, warm_s=(3,),
                                       **geo, **kw)
        pol = m.PrefillBudgetAdmit(**budget) if chunked else None
        runs[name] = (m.serve_continuous_live(copy.deepcopy(trace), eng, tp, dp, ctrl,
                                              backend=be, policy=pol), be)
    int8_pools = all(be.state.tcache["k"].dtype == torch.int8 and "v_scale" in be.state.tcache
                     for _, be in runs.values())
    # every route's tokens against solo generate; where they part, the
    # solo stream's top-2 margin at the first differing token
    divergences = []
    for tag, trace, names in (("trace", reqs, [p[0] for p in plan[:4]]),
                              ("prefix", preqs, ["paged_prefix_cache"])):
        for r in trace:
            solo, _, _ = eng.generate(tp, dp, r.tokens[None], np.array([r.prompt_len], np.int32),
                                      s=3, cache_len=96)
            solo = solo[0][:r.max_new]
            for k in names:
                got = np.asarray(runs[k][1].outputs[r.rid])
                if not np.array_equal(got, solo):
                    t = int(np.argmax(got != solo))
                    divergences.append(dict(
                        route=k, rid=f"{tag}:{r.rid}", token=t,
                        solo_top2_margin=solo_margin(torch, np, eng.target, tp, r, solo, t)))
    # speculative == greedy over the whole trace in one batch
    P = max(r.prompt_len for r in reqs)
    toks = np.zeros((len(reqs), P), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :r.prompt_len] = r.tokens
    lens = np.array([r.prompt_len for r in reqs], np.int32)
    greedy, _, _ = eng.generate(tp, dp, toks, lens, s=0, cache_len=96)
    spec, _, _ = eng.generate(tp, dp, toks, lens, s=3, cache_len=96)
    spec_equal = bool(np.array_equal(greedy, spec))
    n_pre = {k: sum(len(t.preempted) for t in runs[k][0].trace) for k in runs}
    replay_equal = {}
    for name, trace, kw, chunked in plan:
        pgeo = {k: v for k, v in kw.items() if k in ("block_size", "num_blocks", "prefix_cache")}
        replay_equal[name] = replays_equal(
            np, m, runs[name][0], trace, ctrl, m.PrefillBudgetAdmit(**budget) if chunked
            else None, 8, max_context=96, **pgeo)
    hits = [h for t in runs["paged_prefix_cache"][0].trace for h in t.cache_hits]
    plen = {r.rid: r.prompt_len for r in preqs}
    zero_copy = sum(1 for rid, p in hits if p >= plen[rid])
    zero_nocopy = sum(1 for rid, p in hits if p == plen[rid] - 1)
    del runs

    # the model's paged decode_step through K2 and K3, then card against CPU
    state = eng.init_slots(4, 96, block_size=16)
    for slot, r in enumerate(reqs[:3]):
        state = eng.prefill_into(tp, dp, state, slot, r.tokens, r.prompt_len, 96)
    pk = state.paged
    for slot in pk.active_slots():
        pk.ensure(slot, pk.tokens(slot) + 3)
    tables = pk.device_tables()
    state.tcache["bt"].copy_(torch.from_numpy(tables))
    cu = torch.from_numpy(m.host_cu_blocks(tables))
    feed = torch.from_numpy(np.stack([r.tokens[:4] for r in reqs[:4]]).astype(np.int64))
    pool0 = {n: t.clone() for n, t in state.tcache.items()}
    for c in (m.K23.DENSE, m.K23.DENSE_INT8):
        c.launches = 0
    lg_dense, _ = eng.target.decode_step(tp, feed.cuda(), state.tcache, state.seq_lens)
    torch.cuda.synchronize()
    dense_launches = (m.K23.DENSE.launches, m.K23.DENSE_INT8.launches)
    pool_card = {n: t.clone() for n, t in pool0.items()}
    lg_ragged, pool_card = eng.target.decode_step(tp, feed.cuda(), pool_card, state.seq_lens,
                                                  cu.cuda())
    model_equal = bool(torch.equal(lg_dense, lg_ragged))
    tp_cpu = tree_to(tp, "cpu")
    pool_cpu = tree_to(pool0, "cpu")
    lg_cpu, pool_cpu = eng.target.decode_step(tp_cpu, feed, pool_cpu, state.seq_lens.cpu(), cu)
    NB = pool0["pos"].shape[0] - 1          # the trash block takes racing writes
    below = lambda c: {n: t[:, :NB].cpu() for n, t in row_leaves(c).items()}
    paged_cmp = dict(codes_against(torch, below(pool_card), below(pool_cpu)),
                     logits_max_abs_err=float((lg_ragged.cpu() - lg_cpu).abs().max()),
                     logits_ok=within(torch, lg_ragged.cpu(), lg_cpu, Q8_TOL["logits"])[1])
    del state, pool0, pool_card, pool_cpu
    rng = np.random.default_rng(13)
    ptoks = torch.from_numpy(rng.integers(0, vocab, (2, 40)).astype(np.int64))
    plens = torch.tensor([40, 33], dtype=torch.int32)
    vfeed = torch.from_numpy(rng.integers(0, vocab, (2, 4)).astype(np.int64))

    def ring(params, device):
        model = eng.target
        cache = model.init_cache(2, 96, f32, device)
        lg0, cache, seq = model.prefill(params, ptoks.to(device), cache, plens.to(device))
        lg1, cache = model.decode_step(params, vfeed.to(device), cache, seq + 1)
        return (torch.cat([lg0[:, None], lg1], 1).cpu(),
                {n: t.cpu() for n, t in row_leaves(cache).items()})
    (lg_g, rc_g), (lg_c, rc_c) = ring(tp, "cuda"), ring(tp_cpu, "cpu")
    ring_cmp = dict(codes_against(torch, rc_g, rc_c),
                    logits_max_abs_err=float((lg_g - lg_c).abs().max()),
                    logits_ok=within(torch, lg_g, lg_c, Q8_TOL["logits"])[1])
    line = dict(requests=len(reqs), prefix_requests=len(preqs),
                tokens_equal=not divergences, divergences=divergences,
                tie_margin=Q8_TIE_MARGIN, spec_equals_greedy=spec_equal, preemptions=n_pre,
                sim_replay_equal=replay_equal, cache_hits=hits,
                zero_suffix_hits=dict(copy=zero_copy, no_copy=zero_nocopy),
                model_decode_k2_equals_k3=model_equal,
                k2_launches=dict(all=dense_launches[0], int8=dense_launches[1]),
                card_vs_cpu=dict(ring=ring_cmp, paged=paged_cmp, tol=Q8_TOL))
    print("  " + json.dumps(line), flush=True)
    check(int8_pools, "a serving run's pool is not int8 with scales")
    check(all(d["solo_top2_margin"] < Q8_TIE_MARGIN for d in divergences),
          f"int8 routes (paged / contiguous / chunked / mixed / prefix cache) and solo "
          f"tokens differ away from a near-tie: {divergences}")
    check(spec_equal, "int8: speculative tokens differ from greedy")
    check(n_pre["paged"] > 0 and n_pre["paged_mixed"] > 0,
          f"the undersized int8 pool never preempted: {n_pre}")
    check(all(replay_equal.values()),
          f"an int8 StepTrace differs from its SimStepBackend replay: {replay_equal}")
    check(zero_copy > 0 and zero_nocopy > 0 and len(hits) >= 4,
          f"the shared-prompt trace missed the cache or a zero-suffix admission: {hits}")
    check(model_equal, "the int8 paged decode_step differs between K2 and K3")
    check(dense_launches[0] > 0 and dense_launches[0] == dense_launches[1],
          f"the int8 decode_step without cu_blocks ran K2 {dense_launches} (all, int8) times")
    for name, c in (("ring", ring_cmp), ("paged", paged_cmp)):
        check(c["logits_ok"] and codes_ok(c), f"int8 {name}: card and CPU differ: {c}")
    return line


def slot_leaves(torch, st, slot, n):
    """Every per-row leaf of a slot's first ``n`` target rows through its
    table, ``[nL, n, ...]``."""
    ids = torch.tensor(st.paged.table(slot), device="cuda")
    return {name: t[:, ids].flatten(1, 2)[:, :n] for name, t in row_leaves(st.tcache).items()}


def kvq_rows_check(torch, np, m, e_bf, e_q8, tp, dp, vocab, plen=200):
    """One ``plen``-token prompt through ``prefill_into`` on the bf16 and the
    int8 pool (the same weights): layer 0's rows, dequantised in fp32,
    within 1.01 of their stored scale of the bf16 rows (layer 0's inputs
    are equal: half a code, plus 127 times the bf16 rounding of the scale,
    2^-8, is 0.996 of the fp32 scale); every row's largest |code| 127 but
    where the scale sits on its 1e-8 floor; and the first step's logits
    against the fp32 unquantised route (the bf16 weights cast), relative
    RMS within 0.05, beside the bf16 route's own."""
    prompt = np.random.default_rng(31).integers(0, vocab, plen).astype(np.int32)
    toks = np.ones((512,), np.int32)
    toks[:plen] = prompt

    def whole(e, tparams, dparams):
        st = e.init_slots(1, 512, block_size=16)
        return e.prefill_into(tparams, dparams, st, 0, toks, plen, 512)
    st_bf, st_q8 = whole(e_bf, tp, dp), whole(e_q8, tp, dp)
    bf, q8 = slot_leaves(torch, st_bf, 0, plen - 1), slot_leaves(torch, st_q8, 0, plen - 1)
    layer0 = {}
    floor = torch.tensor(1e-8, dtype=torch.bfloat16, device="cuda")
    full_scale = True
    for n in ("k", "v"):
        sc = q8[n + "_scale"].float()[..., None]
        deq = q8[n].float() * sc
        layer0[n] = float(((deq[0] - bf[n][0].float()).abs() / sc[0]).max())
        full_scale &= bool(((q8[n].abs().amax(-1) == 127)
                            | (q8[n + "_scale"] == floor)).all())
    lg = {"bf16": first_step_logits(torch, m, e_bf, tp, st_bf, vocab)[0],
          "int8": first_step_logits(torch, m, e_q8, tp, st_q8, vocab)[0]}
    del st_bf, st_q8, bf, q8
    e32 = m.SpecDecodeEngine(e_bf.tcfg, e_bf.dcfg, max_new=e_bf.max_new, dtype=torch.float32,
                             device="cuda")
    tp32, dp32 = (tree_map(lambda t: t.float(), p) for p in (tp, dp))
    lf = first_step_logits(torch, m, e32, tp32, whole(e32, tp32, dp32), vocab)[0]
    del e32, tp32, dp32
    torch.cuda.empty_cache()
    rel = {k: float(rel_rms_over(v, lf, 0)) for k, v in lg.items()}
    line = dict(prompt=plen, layer0_err_in_stored_scales=layer0, layer0_bound=1.01,
                full_scale_codes=full_scale, first_logits_rel_rms_vs_fp32=rel,
                first_token_equal_bf16=bool(lg["bf16"].argmax() == lg["int8"].argmax()))
    print("  int8 rows vs bf16 and fp32: " + json.dumps(line), flush=True)
    check(all(v <= 1.01 for v in layer0.values()),
          f"int8 layer-0 rows further than 1.01 stored scales from the bf16 rows: {layer0}")
    check(full_scale, "an int8 row's largest |code| is not 127 above the scale's floor")
    check(rel["int8"] <= 0.05, f"int8 first logits' relative RMS to fp32 {rel['int8']} > 0.05")
    return line


def kvq_serve(torch, np, R, m, lut_table, live):
    """bf16, full depth: phase 6b's pair (the same seed), trace and LUT,
    served on the bf16 pool of 144 blocks and on an int8 pool of
    ``q8_blocks(144)`` = 283 blocks (the same bytes), both collecting their
    tokens.  Gated for the int8 run: every request finishes, no preemption
    (the trace's worst case is 16 x 15 = 240 blocks), K1 and K3 launched
    over int8 only, no plain version.  Reported beside phase 6b's own
    numbers: TTFT, ITL, tokens/s, goodput, occupancy, preemptions, pool GB
    and greedy-token agreement with the bf16 run.  Then the numerics
    (``kvq_rows_check``) and one profiled paged step at B = 16, s = 0 of
    each pool (phase 5's)."""
    import copy
    bf16 = torch.bfloat16
    tcfg, dcfg = R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b")
    e_bf = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda")
    e_q8 = m.SpecDecodeEngine(tcfg.with_(kv_quant=True), dcfg.with_(kv_quant=True),
                              max_new=32, dtype=bf16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = e_bf.target.init(gen, bf16, "cuda")
    dp = e_bf.draft.init(gen, bf16, "cuda")
    lut = {int(b): int(v) for b, v in lut_table.items()}
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 32, (64, 192), 32, 0.05, 23)
    nb = q8_blocks(tcfg, 144)
    counters = (m.K1.KERNEL, m.K1.KERNEL_INT8, m.K23.DENSE, m.K23.RAGGED, m.K23.RAGGED_INT8,
                m.K5.FWD, m.ops.PLAIN, m.paged.PLAIN, m.ops.PLAIN_RMSNORM)
    runs, outputs = {}, {}
    for name, e, blocks in (("bf16", e_bf, 144), ("int8", e_q8, nb)):
        ctrl = m.AdaptiveController(lut=m.SpeculationLUT(lut))
        e.load_kernels(paged=True)
        be = m.ContinuousEngineBackend(e, tp, dp, capacity=16, cache_len=512, block_size=16,
                                       num_blocks=blocks, collect_outputs=True,
                                       warm_s=sorted(set(lut.values())),
                                       s_cap=m.controller_s_cap(ctrl))
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = m.serve_continuous_live(copy.deepcopy(reqs), e, tp, dp, ctrl, backend=be)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(k1=m.K1.KERNEL.launches, k1_int8=m.K1.KERNEL_INT8.launches,
                        k2=m.K23.DENSE.launches, k3=m.K23.RAGGED.launches,
                        k3_int8=m.K23.RAGGED_INT8.launches, k5=m.K5.FWD.launches,
                        plain=(m.ops.PLAIN.launches + m.paged.PLAIN.launches
                               + m.ops.PLAIN_RMSNORM.launches))
        done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
        runs[name] = dict(blocks=blocks, pool_gb=sum(t.numel() * t.element_size() for n, t in
                                                     be.state.tcache.items() if n != "bt") / 1e9,
                          finished=len(done), **serve_line(m, res, wall), launches=launches)
        outputs[name] = be.outputs
        del be, res
        torch.cuda.empty_cache()
    same = [np.asarray(outputs["int8"][r.rid]) == np.asarray(outputs["bf16"][r.rid])
            for r in reqs]
    keys = ("ttft", "itl", "tokens_per_s", "goodput", "mean_occupancy", "preemptions")
    line = dict(requests=len(reqs), runs=runs, phase_6b={k: live[k] for k in keys},
                greedy_agreement_with_bf16=float(np.mean(np.concatenate(same))),
                requests_identical_to_bf16=sum(bool(s.all()) for s in same))
    print("  " + json.dumps(line), flush=True)
    q = runs["int8"]
    check(q["finished"] == len(reqs), f"int8: {len(reqs) - q['finished']} requests did not finish")
    check(q["preemptions"] == 0, f"the {nb}-block int8 pool preempted {q['preemptions']} times")
    check(runs["bf16"]["preemptions"] > 0, "the 144-block bf16 pool never preempted")
    L = q["launches"]
    check(L["k1_int8"] > 0 and L["k1_int8"] == L["k1"], f"int8: K1 launches {L}")
    check(L["k3_int8"] > 0 and L["k3_int8"] == L["k3"], f"int8: K3 launches {L}")
    check(L["plain"] == 0, "int8: a plain version ran on the card")
    line["rows"] = kvq_rows_check(torch, np, m, e_bf, e_q8, tp, dp, tcfg.vocab_size)
    rng = np.random.default_rng(5)
    ptoks = rng.integers(0, tcfg.vocab_size, (16, 128)).astype(np.int32)
    prof = {}
    for name, e in (("bf16", e_bf), ("int8", e_q8)):
        state = e.init_slots(16, 512, block_size=16, num_blocks=192)
        for slot in range(16):
            state = e.prefill_into(tp, dp, state, slot, ptoks[slot], 128, 512)
        prof[name] = profile_step(torch, e, tp, dp, f"paged_b16_s0_{name}", state, 0)
        del state
        torch.cuda.empty_cache()
    line["profile"] = dict(prof, kernels_added=prof["int8"]["device_kernels"]
                           - prof["bf16"]["device_kernels"],
                           busy_added_ms=prof["int8"]["device_busy_ms"]
                           - prof["bf16"]["device_busy_ms"])
    check(prof["int8"]["paged_kernel_ms"] > 0, "the profiler saw no K3 in the int8 step")
    return line


def phase_kv_quant(torch, np, R, m, lut_table, live, tree_to):
    """Phase 6e: ``kvq_parity`` (fp32, 2 layers), then ``kvq_serve`` (bf16,
    full depth)."""
    t0 = time.perf_counter()
    line = dict(parity=kvq_parity(torch, np, R, m, tree_to))
    torch.cuda.empty_cache()
    line["serve"] = kvq_serve(torch, np, R, m, lut_table, live)
    line["seconds"] = time.perf_counter() - t0
    print(f"  phase 6e: {line['seconds']:.1f}s", flush=True)
    return line


# ---------------------------------------------------------------------------
# phase 7: the training path


# ---------------------------------------------------------------------------
# phase 6f: stochastic speculative sampling (sample=True)


def capture_draws(m, cap, on_cpu=False):
    """Wrap the engine module's ``_sample_draws`` so that each call's draws
    land in ``cap["draws"]`` (``on_cpu``: the draws are made once on the CPU
    from ``cap["gen"]`` and moved to each caller's device, the
    card-against-CPU replay); returns the original, which the caller puts
    back."""
    sd = m.spec_decode
    orig = sd._sample_draws

    def draws(rng, B, s, V, device):
        if on_cpu:
            if "fixed" not in cap:
                cap["fixed"] = orig(cap["gen"], B, s, V, "cpu")
            out = tuple(t.to(device) for t in cap["fixed"])
        else:
            out = orig(rng, B, s, V, device)
        cap["draws"] = out
        return out
    sd._sample_draws = draws
    return orig


def record_logits(model, rec, key, to_cpu=True):
    """Record the logits of every ``decode_step`` of ``model`` (an instance
    attribute over the class method; ``del model.decode_step`` restores)."""
    fn = type(model).decode_step

    def wrapped(*a, **kw):
        lg, c = fn(model, *a, **kw)
        rec.setdefault(key, []).append(lg.float().cpu() if to_cpu else lg)
        return lg, c
    model.decode_step = wrapped


def eq_mass_bins(np, p, n_bins=16):
    """Each token's bin among ``n_bins`` bins of equal target mass (tokens in
    order of falling ``p``) and each bin's exact mass."""
    order = np.argsort(-p, kind="stable")
    before = np.cumsum(p[order]) - p[order]
    bins = np.empty(len(p), np.int64)
    bins[order] = np.minimum((before * n_bins).astype(np.int64), n_bins - 1)
    return bins, np.bincount(bins, weights=p, minlength=n_bins)


def chi2_against(np, tokens, bins, mass):
    """Pearson's chi-square of ``tokens`` binned by ``bins`` against the
    bins' masses (empty bins dropped), and its p-value."""
    from scipy.stats import chi2
    keep = mass > 0
    obs = np.bincount(bins[tokens], minlength=len(mass))[keep]
    exp = mass[keep] * len(tokens)
    stat = float(((obs - exp) ** 2 / exp).sum())
    return dict(stat=stat, df=int(keep.sum()) - 1, p_value=float(chi2.sf(stat, keep.sum() - 1)),
                observed=obs.tolist(), expected=[round(float(x), 1) for x in exp])


def sampled_step_margins(torch, np, draft_lg, verify_lg, draws, a, T):
    """Per row of one sampled step, the smallest margin of the decisions it
    took, in logit units: each draft draw's top-2 gap of ``x / T + g``, each
    acceptance test it ran ``|log u - min(log p - log q, 0)|``, and the
    residual draw's top-2 gap at its cut ``a``.  From the step's recorded
    draft logits (``s`` of ``[B, V]``), verify logits ``[B, s + 1, V]`` and
    draws, fp32 on the CPU."""
    g_draft, u, g_res = (t.cpu() for t in draws)
    s, B = len(draft_lg), verify_lg.shape[0]

    def top2(x):
        v = x.topk(2, -1).values
        return v[..., 0] - v[..., 1]
    logp = torch.log_softmax(verify_lg / T, -1)
    p = logp.exp()
    out = []
    for b in range(B):
        gaps, cut = [], int(a[b])
        for i, lg in enumerate(draft_lg):
            x = lg[b] / T + g_draft[i, b]
            gaps.append(float(top2(x)))
            if i <= cut and i < s:
                d = int(x.argmax())
                logq = torch.log_softmax(lg[b] / T, -1)
                gaps.append(abs(math.log(max(float(u[b, i]), 1e-45))
                                - min(float(logp[b, i, d] - logq[d]), 0.0)))
        resid = p[b, cut] - (torch.softmax(draft_lg[cut][b] / T, -1) if cut < s else 0.0)
        resid = resid.clamp(min=0.0)
        resid = resid / resid.sum().clamp(min=1e-20)
        gaps.append(float(top2(torch.log(resid.clamp(min=1e-30)) + g_res[b])))
        out.append(min(gaps))
    return out


def sampled_card_vs_cpu(torch, np, R, m, tree_to, steps=3, s=3):
    """fp32, the full-width pair cut to 2 layers (phase 3's cut): the
    greedy logits' card-against-CPU deviation, then ``steps`` sampled steps
    at ``s`` on the card and on the CPU from the same prompts, each fed the
    same draws (made on the CPU, through ``_sample_draws``).  Tokens and
    counts must be equal; a row may part only at a near-tie, where the CPU
    step's smallest decision margin is below twice the greedy deviation."""
    f32 = torch.float32
    tcfg = R.get_config("opt-6.7b").with_(n_layers=2)
    dcfg = R.get_draft_config("opt-6.7b").with_(n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    e_cpu = m.SpecDecodeEngine(tcfg, dcfg, max_new=16, dtype=f32, device="cpu", sample=True)
    e_gpu = m.SpecDecodeEngine(tcfg, dcfg, max_new=16, dtype=f32, device="cuda", sample=True)
    tp_gpu = e_gpu.target.init(gen, f32, "cuda")      # made on the card: seconds, not tens
    dp_gpu = e_gpu.draft.init(gen, f32, "cuda")
    tp_cpu, dp_cpu = tree_to(tp_gpu, "cpu"), tree_to(dp_gpu, "cpu")
    rng = np.random.default_rng(19)
    toks = rng.integers(0, tcfg.vocab_size, (4, 16)).astype(np.int32)
    lens = np.array([16, 12, 9, 16], np.int32)
    tt, tl = torch.from_numpy(toks.astype(np.int64)), torch.from_numpy(lens)
    lg_g, _ = greedy_logits(torch, e_gpu.target, tp_gpu, tt, tl, 8, 64, "cuda")
    lg_c, _ = greedy_logits(torch, e_cpu.target, tp_cpu, tt, tl, 8, 64, "cpu")
    dev = float((lg_g - lg_c).abs().max())
    st_g = e_gpu.prefill(tp_gpu, dp_gpu, toks, lens, 64)
    st_c = e_cpu.prefill(tp_cpu, dp_cpu, toks, lens, 64)
    cap, rec = {}, {}
    orig = capture_draws(m, cap, on_cpu=True)
    record_logits(e_cpu.draft, rec, "draft")
    record_logits(e_cpu.target, rec, "verify")
    parted, divergences, equal_steps = set(), [], 0
    try:
        for k in range(steps):
            cap.clear()
            rec.clear()
            cap["gen"] = torch.Generator().manual_seed(100 + k)
            live = ~st_c.done.numpy()
            st_g, sg = e_gpu.step(tp_gpu, dp_gpu, st_g, s, torch.Generator(device="cuda"))
            st_c, sc = e_cpu.step(tp_cpu, dp_cpu, st_c, s, torch.Generator())
            out_g, out_c = st_g.out.cpu().numpy(), st_c.out.numpy()
            rows = [b for b in range(4) if live[b] and b not in parted and not (
                np.array_equal(out_g[b], out_c[b]) and sg.accepted[b] == sc.accepted[b]
                and sg.committed[b] == sc.committed[b])]
            equal_steps += not rows
            if rows:
                dl = [rec["draft"][0][:, -1]] + [x[:, 0] for x in rec["draft"][1:]]
                margins = sampled_step_margins(torch, np, dl, rec["verify"][0], cap["draws"],
                                               sc.accepted, e_cpu.temperature)
                for b in rows:
                    parted.add(b)
                    divergences.append(dict(step=k, row=b, cpu_margin=margins[b]))
    finally:
        m.spec_decode._sample_draws = orig
        del e_cpu.draft.decode_step, e_cpu.target.decode_step
    return dict(greedy_logits_dev=dev, tie_margin=2 * dev, steps=steps, s=s,
                equal_steps=equal_steps, divergences=divergences)


def sampled_draft_is_target(torch, np, m, tcfg, tp, dtype, steps=3, s=3, B=4):
    """The target as its own draft, the same parameters: every live row
    accepts every draft token (p = q) in each of ``steps`` steps."""
    eng = m.SpecDecodeEngine(tcfg, tcfg, max_new=32, dtype=dtype, device="cuda", sample=True)
    rng = np.random.default_rng(29)
    toks = rng.integers(0, tcfg.vocab_size, (B, 16)).astype(np.int32)
    st = eng.prefill(tp, tp, toks, np.full((B,), 16, np.int32), 64)
    acc = []
    for k in range(steps):
        live = ~st.done.cpu().numpy()
        st, stats = eng.step(tp, tp, st, s, torch.Generator(device="cuda").manual_seed(k))
        acc.append(stats.accepted[live].tolist())
    return acc


def sampled_rows(torch, np, m, eng, tp, dp, prompt, s, rows, batch, seed, bounds):
    """``rows`` rows of one prompt through one sampled step at ``s``,
    ``batch`` rows a call: each row's first committed token and accept
    count, and (s > 0) the draft's first proposal, from the draft's first
    logits and the step's own draws (both captured).  The bounds on every
    step go into ``bounds``."""
    cap, rec = {}, {}
    orig = capture_draws(m, cap)
    record_logits(eng.draft, rec, "draft", to_cpu=False)
    first, acc, prop = [], [], []
    try:
        for k in range(rows // batch):
            rec.clear()
            st = eng.prefill(tp, dp, np.repeat(prompt[None], batch, 0),
                             np.full((batch,), len(prompt), np.int32), 32)
            st, stats = eng.step(tp, dp, st, s,
                                 torch.Generator(device="cuda").manual_seed(seed + k))
            first.append(st.out[:, 0].cpu().numpy())
            acc.append(stats.accepted)
            n_gen = st.n_generated.cpu().numpy()
            out = st.out.cpu().numpy()
            bounds["steps"] += 1
            bounds["ok"] &= bool((stats.accepted >= 0).all() and (stats.accepted <= s).all()
                                 and (stats.committed <= stats.accepted + 1).all()
                                 and (n_gen >= 1).all())
            bounds["ok"] &= all(bool((out[b, :n_gen[b]] < eng.tcfg.vocab_size).all())
                                for b in range(batch))
            if s:
                lg0 = rec["draft"][0][:, -1]
                prop.append(torch.argmax(lg0 / eng.temperature + cap["draws"][0][0], -1)
                            .cpu().numpy())
            cap.clear()
    finally:
        m.spec_decode._sample_draws = orig
        del eng.draft.decode_step
    return (np.concatenate(first), np.concatenate(acc),
            np.concatenate(prop) if prop else None)


def tip_probs(torch, np, model, params, prompt, vocab):
    """``model``'s next-token distribution after ``prompt`` (a prefill on
    the card, bf16), over the true vocabulary, in float64."""
    cache = model.init_cache(1, 32, torch.bfloat16, "cuda")
    lg, _, _ = model.prefill(params, torch.from_numpy(prompt[None].astype(np.int64)).cuda(),
                             cache, torch.tensor([len(prompt)], dtype=torch.int32,
                                                 device="cuda"))
    p = torch.softmax(lg[0].double(), -1)[:vocab].cpu().numpy()
    return p / p.sum()


def launch_counts(m):
    return dict(k1=m.K1.KERNEL.launches, k3=m.K23.RAGGED.launches, k5=m.K5.FWD.launches,
                plain=(m.ops.PLAIN.launches + m.paged.PLAIN.launches
                       + m.ops.PLAIN_RMSNORM.launches))


def zero_counts(m):
    for c in (m.K1.KERNEL, m.K23.RAGGED, m.K5.FWD, m.ops.PLAIN, m.paged.PLAIN,
              m.ops.PLAIN_RMSNORM):
        c.launches = 0


def phase_sampling(torch, np, R, m, tree_to, n_rows=8192, batch=1024):
    """``sample=True`` on the card.  fp32: the full-width OPT-6.7B as its
    own draft accepts every draft token (3 steps, s 3, B 4); the 2-layer
    cut against the CPU on the same draws.  bf16 on phase 6b's pair and
    seed: ``n_rows`` rows of one 16-token prompt through one s = 3 step
    (and through one s = 0 step, the control): the first committed tokens,
    binned into 16 bins of equal target mass, pass a chi-square test
    (p > 1e-3), the draft's own first proposals fail it (the test's power),
    and the rate of accepted first draft tokens lies within 4 sigma of
    sum_v min(p, q); the bounds on every step.  Measured: acceptance at
    s 1, 3 and 5 over 64 prompts, the sampled LUT on a reduced grid of
    phase 4's profile (its greedy grid is phase 4's), and step profiles
    greedy against sampled; the seconds of each part."""
    bf16, f32 = torch.bfloat16, torch.float32
    tcfg, dcfg = R.get_config("opt-6.7b"), R.get_draft_config("opt-6.7b")
    vocab = tcfg.vocab_size
    line, secs = {}, {}
    t0 = time.perf_counter()
    # ---- draft = target, fp32 at full width (bf16 reported beside it) ----
    tp32 = m.DecoderLM(tcfg).init(torch.Generator(device="cuda").manual_seed(17), f32, "cuda")
    line["draft_is_target_fp32"] = sampled_draft_is_target(torch, np, m, tcfg, tp32, f32)
    del tp32
    torch.cuda.empty_cache()
    secs["draft_is_target_fp32"] = time.perf_counter() - t0
    # ---- card against CPU, the same draws ----
    t0 = time.perf_counter()
    line["card_vs_cpu"] = sampled_card_vs_cpu(torch, np, R, m, tree_to)
    torch.cuda.empty_cache()
    secs["card_vs_cpu"] = time.perf_counter() - t0
    # ---- bf16, full width ----
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=256, dtype=bf16, device="cuda", sample=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    eng.load_kernels(paged=True)
    line["draft_is_target_bf16"] = sampled_draft_is_target(torch, np, m, tcfg, tp, bf16)
    t0 = time.perf_counter()
    prompt = np.random.default_rng(31).integers(0, vocab, 16).astype(np.int32)
    p = tip_probs(torch, np, eng.target, tp, prompt, vocab)
    q = tip_probs(torch, np, eng.draft, dp, prompt, vocab)
    bins, mass = eq_mass_bins(np, p)
    bounds = {"ok": True, "steps": 0}
    zero_counts(m)
    t0 = time.perf_counter()
    first3, acc3, prop = sampled_rows(torch, np, m, eng, tp, dp, prompt, 3, n_rows, batch, 1000,
                                      bounds)
    first0, _, _ = sampled_rows(torch, np, m, eng, tp, dp, prompt, 0, n_rows, batch, 5000,
                                bounds)
    torch.cuda.synchronize()
    exact_s = secs["exactness"] = time.perf_counter() - t0
    launches_exact = launch_counts(m)
    expected_rate = float(np.minimum(p, q).sum())
    rate = float((acc3 >= 1).mean())
    sigma = math.sqrt(expected_rate * (1 - expected_rate) / n_rows)
    line["exactness"] = dict(
        rows=n_rows, batch=batch, seconds=exact_s, p_max=float(p.max()),
        bin_mass=[round(float(x), 4) for x in mass],
        spec_s3=chi2_against(np, first3, bins, mass),
        plain_s0=chi2_against(np, first0, bins, mass),
        draft_proposals=chi2_against(np, prop, bins, mass),
        first_accept_rate=rate, expected_rate=expected_rate, sigma=sigma,
        accepted_hist=np.bincount(acc3, minlength=4).tolist(),
        tv_draft_target=float(0.5 * np.abs(p - q).sum()),
        launches=launches_exact, bounds=bounds)
    # ---- acceptance at s 1, 3, 5 over 64 prompts ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    ps = m.synthetic_prompts(64, vocab, rng, 8, 16)
    toks = np.zeros((64, 16), np.int32)
    for i, pr in enumerate(ps):
        toks[i, :len(pr)] = pr
    lens = np.array([len(pr) for pr in ps], np.int32)
    line["acceptance"] = {}
    for s in (1, 3, 5):
        runs = np.asarray(m.measure_acceptance(eng, tp, dp, toks, lens, s=s, gen_tokens=8,
                                               cache_len=256))
        line["acceptance"][s] = dict(draws=int(runs.size), mean_accepted=float(runs.mean()),
                                     per_token=float(runs.mean() / s),
                                     first_accepted=float((runs >= 1).mean()),
                                     hist=np.bincount(runs, minlength=s + 1).tolist())
    secs["acceptance"] = time.perf_counter() - t0
    # ---- phase 4's profile, sampled, on a reduced grid (phase 4's sample) ----
    t0 = time.perf_counter()
    ps = m.synthetic_prompts(8, vocab, np.random.default_rng(1), 8, 16)
    ptoks = np.zeros((8, 16), np.int32)
    for i, pr in enumerate(ps):
        ptoks[i, :len(pr)] = pr
    plens = np.array([len(pr) for pr in ps], np.int32)
    zero_counts(m)
    lut = m.profile_engine(eng, tp, dp, ptoks, plens, batch_sizes=(1, 4, 8),
                           s_values=(0, 1, 3), gen_tokens=8, cache_len=256)
    line["lut_sampled"] = dict(table=dict(lut.table), launches=launch_counts(m),
                               ms_per_token={b: {s: 1e3 * t for s, t in d.items()}
                                             for b, d in lut.per_token.items()})
    secs["lut"] = time.perf_counter() - t0
    # ---- step profiles, greedy against sampled; wall times in turns ----
    t0 = time.perf_counter()
    line["profiles"] = {}
    ring_toks = np.random.default_rng(5).integers(0, vocab, (8, 16)).astype(np.int32)
    ptoks = np.random.default_rng(6).integers(0, vocab, (16, 128)).astype(np.int32)
    launches_prof = {mode: dict.fromkeys(("k1", "k3", "k5", "plain"), 0)
                     for mode in ("greedy", "sampled")}
    zero_counts(m)
    for cfg, s in (("ring_b8_s3", 3), ("paged_b16_s0", 0), ("paged_b16_s3", 3)):
        keep = []
        if cfg.startswith("paged"):
            # one pool for every run of this shape: they add 30-200 tokens to 128
            st = eng.init_slots(16, 512, block_size=16, num_blocks=448)
            for slot in range(16):
                st = eng.prefill_into(tp, dp, st, slot, ptoks[slot], 128, 512)
            keep.append(st)

        def state():
            return (keep[-1] if keep else
                    eng.prefill(tp, dp, ring_toks, np.full((8,), 16, np.int32), 256))
        row = {}
        for mode in ("greedy", "sampled"):
            eng.sample = mode == "sampled"
            before = launch_counts(m)
            r = profile_step(torch, eng, tp, dp, f"{cfg}_{mode}", state(), s, steps=2,
                             keep=keep if keep else None, host=False)
            for k, v in launch_counts(m).items():
                launches_prof[mode][k] += v - before[k]
            row[mode] = {k: r[k] for k in ("device_busy_ms", "device_kernels", "idle_share",
                                           "k1_ms", "paged_kernel_ms", "k5_ms",
                                           "profile_takes", "profile_lost")}
            row[mode]["wall_ms"] = []
        # unprofiled wall times in turns (greedy, sampled, sampled, greedy):
        # the host clock of one process drifts by more than sampling costs
        for mode in ("greedy", "sampled", "sampled", "greedy"):
            eng.sample = mode == "sampled"
            st, _ = eng.step(tp, dp, state(), s)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(6):
                st, _ = eng.step(tp, dp, st, s)
            row[mode]["wall_ms"].append(1e3 * (time.perf_counter() - t1) / 6)
            if keep:
                keep.append(st)
        line["profiles"][cfg] = row
    line["profiles"]["launches"] = launches_prof
    eng.sample = True
    secs["profiles"] = time.perf_counter() - t0
    line["seconds"] = secs
    ex = line["exactness"]
    print("  " + json.dumps(line), flush=True)
    check(all(a == 3 for st in line["draft_is_target_fp32"] for a in st),
          f"fp32 draft = target: a draft token was rejected: {line['draft_is_target_fp32']}")
    cvc = line["card_vs_cpu"]
    check(all(d["cpu_margin"] < cvc["tie_margin"] for d in cvc["divergences"]),
          f"sampled card and CPU tokens part away from a near-tie: {cvc}")
    check(bounds["ok"] and bounds["steps"] == 2 * n_rows // batch,
          f"a sampled step broke 0 <= a <= s, committed <= a + 1 or the vocabulary: {bounds}")
    check(ex["spec_s3"]["p_value"] > 1e-3,
          f"s = 3 first tokens are not distributed as the target: {ex['spec_s3']}")
    check(ex["plain_s0"]["p_value"] > 1e-3,
          f"s = 0 sampled tokens are not distributed as the target: {ex['plain_s0']}")
    check(ex["draft_proposals"]["p_value"] < 1e-3,
          f"the draft's proposals pass the test, so it has no power: {ex['draft_proposals']}")
    check(abs(rate - expected_rate) <= 4 * sigma,
          f"first-token acceptance {rate} is not within 4 sigma ({sigma}) of sum min(p, q) "
          f"{expected_rate}")
    check(launches_exact["k1"] > 0 and launches_prof["sampled"]["k3"] > 0
          and launches_exact["plain"] == 0 and launches_prof["sampled"]["plain"] == 0,
          f"the sampled path missed K1 or K3, or ran a plain version: {launches_exact}, "
          f"{launches_prof}")
    return line


# ---------------------------------------------------------------------------
# phase 6g: the telemetry hub


def scope_table(path):
    """Per ``repro/*`` scope of a Chrome trace: its calls (the host-side
    ``user_annotation`` ranges), the device time of the kernels, copies and
    fills inside its ``gpu_user_annotation`` ranges, and that time's share
    of the trace's device time."""
    import bisect
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    base = lambda name: name.split("[")[0]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], base(e["name"])) for e in evs
                    if e.get("cat") == "gpu_user_annotation")
    starts = [r[0] for r in ranges]
    calls, dev_us, total = {}, {}, 0.0
    for e in evs:
        if e.get("cat") == "user_annotation" and e["name"].startswith("repro/"):
            calls[base(e["name"])] = calls.get(base(e["name"]), 0) + 1
        elif e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            total += e["dur"]
            i = bisect.bisect_right(starts, e["ts"]) - 1
            name = ranges[i][2] if i >= 0 and e["ts"] < ranges[i][1] else "(no scope)"
            dev_us[name] = dev_us.get(name, 0.0) + e["dur"]
    names = {e["name"] for e in evs if e.get("cat") == "user_annotation"}
    return dict(
        device_ms=total / 1e3,
        scopes={k: dict(calls=calls.get(k, 0), device_ms=dev_us.get(k, 0.0) / 1e3,
                        share=dev_us.get(k, 0.0) / total if total else None)
                for k in sorted(set(calls) | set(dev_us))},
        step_scope=any(n.startswith("repro/step[") for n in names))


def phase_telemetry(torch, np, R, m):
    """The telemetry hub on phase 6b's pair (the target cut to 16 layers),
    seed, trace (every arrival at 0:
    the live clock advances by wall time, so the hub-off and hub-on runs
    admit alike) and pool of 144 blocks, ``sample=True`` at s = 3, so the
    acceptance observatory has draws: served with no hub, with an enabled
    hub, and with an enabled hub holding ``jsonl_path`` and ``profile_dir``
    under ``build/``.  Gates: tokens and StepTrace fields equal, preempted,
    every request retired, committed tokens counted, a ``repro/step[...]``
    scope in the profiler's trace, ``engine.annotate`` restored, K1 and
    K3 launched and no plain version.  Measured: wall time and the virtual
    clock's makespan in each mode (not gated), the per-scope device time,
    the observatory's table."""
    import copy
    bf16 = torch.bfloat16
    # the target cut to 16 of its 32 layers (widths kept), to keep the
    # script near 800 s with phase 9; the hub's contract does not depend on it
    tcfg = R.get_config("opt-6.7b").with_(n_layers=16)
    dcfg = R.get_draft_config("opt-6.7b")
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda", sample=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 32, (64, 192), 32, 0.0, 23)
    ctrl = m.fixed_controller(3)
    out_dir = os.path.join(ROOT, "build", "telemetry")
    os.makedirs(out_dir, exist_ok=True)

    def run(tel):
        be = m.ContinuousEngineBackend(eng, tp, dp, capacity=16, cache_len=512,
                                       block_size=16, num_blocks=144, collect_outputs=True,
                                       warm_s=(3,))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp, ctrl, backend=be,
                                      telemetry=tel)
        torch.cuda.synchronize()
        return res, be, time.perf_counter() - t0

    fields = ("admitted", "occupancy", "committed", "preempted", "done_rids", "chunked")
    zero_counts(m)
    r_off, b_off, wall_off = run(None)
    launches = launch_counts(m)
    tel_on = m.Telemetry()
    r_on, b_on, wall_on = run(tel_on)
    tel = m.Telemetry(jsonl_path=os.path.join(out_dir, "events.jsonl"),
                      profile_dir=os.path.join(out_dir, "profile"))
    annotate_before = eng.annotate
    r_pr, b_pr, wall_pr = run(tel)
    tel.close()
    t0 = time.perf_counter()
    scopes = scope_table(tel.trace_path)
    parse_s = time.perf_counter() - t0

    def same(res, be):
        return (all([getattr(t, f) for t in r_off.trace] == [getattr(t, f) for t in res.trace]
                    for f in fields)
                and set(b_off.outputs) == set(be.outputs)
                and all(np.array_equal(b_off.outputs[r], be.outputs[r]) for r in b_off.outputs))
    line = dict(
        requests=len(reqs), wall_s=dict(off=wall_off, on=wall_on, on_profiler=wall_pr),
        # the virtual clock: the timed regions alone (the profiled run's wall
        # also holds the trace's export)
        makespan_s={k: max(q.finish for q in r.requests)
                     for k, r in (("off", r_off), ("on", r_on), ("on_profiler", r_pr))},
        launches_off=launches,
        trace_parse_s=parse_s, trace_mb=os.path.getsize(tel.trace_path) / 1e6,
        equal=dict(on=same(r_on, b_on), on_profiler=same(r_pr, b_pr)),
        steps=len(r_pr.batches), preempted=sum(len(t.preempted) for t in r_pr.trace),
        counters=tel.counters, tokens_committed=tel.tokens_committed,
        n_generated=sum(r.n_generated for r in r_pr.requests), iterations=tel.iterations,
        events=len(tel.events), peaks=tel.peaks, annotate_after=eng.annotate,
        scopes=scopes, acceptance=tel.acceptance_table(), summary_gauges=tel.gauges)
    print("  " + json.dumps(line, default=float), flush=True)
    check(line["equal"]["on"] and line["equal"]["on_profiler"],
          "tokens or StepTrace differ with the telemetry hub on")
    check(tel.counters.get("preempt", 0) > 0, "the hub's run never preempted")
    check(tel.counters.get("retire") == len(reqs),
          f"retire spans {tel.counters.get('retire')} != {len(reqs)} requests")
    check(line["tokens_committed"] == line["n_generated"],
          "the hub's committed tokens differ from the requests' n_generated")
    check(scopes["step_scope"], "no repro/step[...] scope in the profiler's trace")
    check(not annotate_before and not eng.annotate, "engine.annotate not restored")
    check(launches["k1"] > 0 and launches["k3"] > 0 and launches["plain"] == 0,
          f"the sampled serving run missed K1 or K3, or ran a plain version: {launches}")
    return line


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
    from torch.profiler import ProfilerActivity
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

    def body():
        nonlocal params, state
        for b in batches[1:]:
            params, state, _ = step(params, state, b)
    prof, takes, lost = whole_profile(torch, body,
                                      [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                      train_kinds(m))
    wall_ms = 1e3 * (time.perf_counter() - t0) / 2 / takes
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
                                                     reverse=True)[:6]},
        profile_takes=takes, profile_lost=lost)
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


def phase_mamba_train(torch, m):
    """The mamba2-1.3b trainer at full width and depth, fp32, batch 4, seq
    512 (two chunks of 256: the carried state and its gradient on the
    path), 20 steps on the markov stream through ``repro_torch.launch.train``,
    every launch count zeroed before it and read after: K6's forward and
    backward once per layer a step, K5 forward and backward, no plain
    version; then, on a second model, two steps timed unprofiled and two
    under ``torch.profiler`` for the device-busy share and K6's and K5's
    shares of the device time."""
    from torch.profiler import ProfilerActivity
    counters = (m.K6.KERNEL, m.K6.KERNEL_BWD, m.K5.FWD, m.K5.BWD, m.ops.PLAIN_SSD,
                m.ops.PLAIN_RMSNORM, m.ops.PLAIN, m.ops.PLAIN_FLASH)
    steps, batch, seq = 20, 4, 512
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    res = m.train.main(["--arch", "mamba2-1.3b", "--device", "cuda", "--steps", str(steps),
                        "--batch", str(batch), "--seq", str(seq)])
    torch.cuda.synchronize()
    launches = dict(k6_fwd=m.K6.KERNEL.launches, k6_bwd=m.K6.KERNEL_BWD.launches,
                    k5_fwd=m.K5.FWD.launches, k5_bwd=m.K5.BWD.launches,
                    plain=sum(c.launches for c in counters[4:]))
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["launches"] = launches

    cfg = m.R.get_config("mamba2-1.3b")
    model = m.R.build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1), torch.float32, "cuda")
    state = m.init_adamw(params)
    step = m.make_train_step(model, cfg, m.AdamWConfig(warmup_steps=2, total_steps=20))
    dc = m.DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq, seed=0)
    batches = [{"tokens": torch.from_numpy(m.batch_at(dc, i)["tokens"]).cuda()}
               for i in range(5)]
    params, state, _ = step(params, state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:3]:
        params, state, met = step(params, state, b)
    torch.cuda.synchronize()
    wall_unprofiled_ms = 1e3 * (time.perf_counter() - t0) / 2
    t0 = time.perf_counter()

    def body():
        nonlocal params, state
        for b in batches[3:]:
            params, state, _ = step(params, state, b)
    prof, takes, lost = whole_profile(torch, body,
                                      [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                      train_kinds(m))
    wall_ms = 1e3 * (time.perf_counter() - t0) / 2 / takes
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.device_time_total / 1e3 / 2
    busy = sum(by.values())
    k6_bwd = sum(t for k, t in by.items() if "ssd_bwd" in k)
    k6_fwd = sum(t for k, t in by.items() if "ssd_" in k) - k6_bwd
    k5 = sum(t for k, t in by.items() if "rmsnorm" in k)
    # the profiler's own host cost (about 11000 device kernels a step) makes
    # the profiled steps slower than unprofiled ones, so busy_share (within
    # the profiled steps) is a floor; busy_share_est divides the same busy
    # time by the wall time of two unprofiled steps of this model just
    # before: an estimate across two pairs of steps, not one measurement
    res["profile"] = dict(
        wall_ms_profiled=wall_ms, wall_ms_unprofiled=wall_unprofiled_ms,
        device_busy_ms=busy, busy_share=busy / wall_ms,
        busy_share_est=busy / wall_unprofiled_ms,
        k6_fwd_ms=k6_fwd, k6_bwd_ms=k6_bwd, k5_ms=k5, k6_share=(k6_fwd + k6_bwd) / busy,
        k5_share=k5 / busy,
        device_kernels=sum(1 for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA) / 2,
        top_device_ms={k[:60]: t for k, t in sorted(by.items(), key=lambda kv: kv[1],
                                                     reverse=True)[:8]},
        profile_takes=takes, profile_lost=lost)
    del params, state, batches
    print("  " + json.dumps(res), flush=True)
    nl = cfg.n_layers
    check(res["losses"][-1] < res["losses"][0], "the Mamba-2 trainer's loss did not fall")
    check(launches["k6_fwd"] == nl * steps and launches["k6_bwd"] == nl * steps,
          f"K6 was not launched once per layer a step, forward and backward: {launches}")
    check(launches["k5_fwd"] > 0 and launches["k5_bwd"] > 0, f"K5 never launched: {launches}")
    check(launches["plain"] == 0, "a plain version ran on the card")
    check(res["peak_memory_gb"] < 80, "the Mamba-2 trainer does not fit one 80 GB card")
    check(res["profile"]["device_busy_ms"] > 0, "the profiler saw no device time")
    return res


def phase_mamba_train_parity(torch, np, m, tree_to):
    """One fp32 train step of mamba2-1.3b cut to 2 layers (widths kept), B 2,
    T 512 (two chunks), on the card (K6 and K5, forward and backward) and
    on the CPU (plain versions): the loss within 1e-5 relative, each
    gradient within 1e-4 of its tensor's largest entry, the grad norm
    within 1e-5 relative."""
    cfg = m.R.get_config("mamba2-1.3b").with_(n_layers=2)
    model = m.R.build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(7), torch.float32, "cpu")
    p_gpu = tree_to(p_cpu, "cuda")
    dc = m.DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=512, seed=11)
    toks = torch.from_numpy(m.batch_at(dc, 0)["tokens"])
    loss_fn = m.make_loss_fn(model, cfg)
    k6_0, plain_0 = m.K6.KERNEL_BWD.launches, m.ops.PLAIN_SSD.launches
    met_g, gr_g = m.value_and_grad(loss_fn, p_gpu, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    k6_bwd, plain_card = m.K6.KERNEL_BWD.launches - k6_0, m.ops.PLAIN_SSD.launches - plain_0
    t0 = time.perf_counter()
    met_c, gr_c = m.value_and_grad(loss_fn, p_cpu, {"tokens": toks})
    cpu_s = time.perf_counter() - t0
    loss_g, loss_c = float(met_g["loss"].cpu()), float(met_c["loss"])

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
                grad_rel_err={k: rel[k] for k in sorted(rel)},
                grad_norm_card=float(gn_g.cpu()), grad_norm_cpu=float(gn_c),
                k6_bwd_launches=k6_bwd, plain_ssd_on_card=plain_card, cpu_step_s=cpu_s)
    print("  " + json.dumps(line), flush=True)
    check(k6_bwd == cfg.n_layers, f"the card's step launched K6's backward {k6_bwd} times")
    check(plain_card == 0, "the plain SSD scan ran on the card")
    check(line["loss_rel_err"] <= 1e-5, f"card vs CPU Mamba-2 loss differs: {line}")
    check(worst <= 1e-4, f"card vs CPU Mamba-2 gradient {worst_name} differs by {worst} "
          "of its max")
    check(abs(line["grad_norm_card"] - line["grad_norm_cpu"]) <= 1e-5 * line["grad_norm_cpu"],
          "card vs CPU Mamba-2 grad norm differs")
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


# phase 8 serves mamba2-1.3b cut to its first 24 of 48 layers (widths kept),
# to keep the script near 800 s with phase 9; phase 7 trains it at full depth
MAMBA_SERVE_LAYERS = 24


@contextlib.contextmanager
def cut_depth(R, n_layers):
    """While the block runs, ``R.get_config`` gives each config cut to its
    first ``n_layers`` layers (widths kept), for an entry point that builds
    its own (``serve.main``)."""
    get = R.get_config
    R.get_config = lambda arch: get(arch).with_(n_layers=n_layers)
    try:
        yield
    finally:
        R.get_config = get


def phase_mamba_serve(torch, m):
    """The paper's profile -> LUT -> adaptive loop on mamba2-1.3b at full
    width, cut to ``MAMBA_SERVE_LAYERS`` layers, with its dense_draft,
    bf16, phase 4's other flags but s 0-3 and 8 requests (cut from 0-6 and
    16 to make room for phases 6f and 6g); K6, K5 and K1 (the draft)
    counted around it and no plain version."""
    counters = (m.K1.KERNEL, m.K5.FWD, m.K6.KERNEL, m.ops.PLAIN, m.ops.PLAIN_RMSNORM,
                m.ops.PLAIN_SSD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    with cut_depth(m.R, MAMBA_SERVE_LAYERS):
        res = m.serve.main(["--arch", "mamba2-1.3b", "--device", "cuda", "--dtype",
                            "bfloat16", "--max-batch", "8", "--cache-len", "256",
                            "--profile-bs", "1,2,4,8", "--s-max", "3", "--requests", "8",
                            "--interval", "0.1", "--max-new", "32"])
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
    check(res["adaptive"]["n"] == 8 and res["no_spec"]["n"] == 8,
          "not every request finished")
    return res


def phase_mamba_continuous(torch, np, m, lut_table):
    """bf16, full width, ``MAMBA_SERVE_LAYERS`` layers: serve_continuous_live
    on a contiguous pool of 8 slots, 16 requests of 64-256 prompt tokens and
    32 new, with the LUT of the Mamba-2 serve loop; K6 counted inside
    prefill_into."""
    R, bf16 = m.R, torch.bfloat16
    tcfg = R.get_config("mamba2-1.3b").with_(n_layers=MAMBA_SERVE_LAYERS)
    dcfg = R.get_draft_config("mamba2-1.3b")
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


# ---------------------------------------------------------------------------
# phase 9: the Qwen3 and Yi configs (qwen3-8b, yi-34b, qwen3-moe-30b-a3b)


QWEN_YI = ("qwen3-8b", "yi-34b", "qwen3-moe-30b-a3b")


def no_drop(cfg):
    """``cfg`` with a MoE capacity factor of n_experts / top_k (16 for
    qwen3-moe-30b-a3b): the capacity is then at least a group's tokens, and
    since a token picks an expert at most once no assignment can drop, so a
    token's output does not depend on the rows dispatched with it.  A dense
    config is returned as it is."""
    if cfg.moe is None:
        return cfg
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def k5_per_layer(cfg):
    """K5 calls a decoder layer: the attention and MLP norms, and the q and k
    norms under ``qk_norm``."""
    return 4 if cfg.attn.qk_norm else 2


def predicted_launches(tcfg, dcfg, prefills, s_steps):
    """K1, K3 and K5 launches of a paged ``serve_continuous_live`` run that
    admits whole prompts: each admission (``prefill_into``) is a target and
    a draft prefill on a ring (K1 a layer; K5 a layer's norms and the final
    norm); each step at s runs s draft forwards (K1 a draft layer, 2 K5 a
    draft layer and its final norm) and one paged verify of the target (K3
    a layer, K5 a layer's norms and the final norm)."""
    nt, nd = tcfg.n_layers, dcfg.n_layers
    kt, kd = k5_per_layer(tcfg) * nt + 1, 2 * nd + 1
    drafts = sum(s_steps)
    return dict(k1=prefills * (nt + nd) + drafts * nd, k3=len(s_steps) * nt,
                k5=prefills * (kt + kd) + len(s_steps) * kt + drafts * kd)


def paged_tokens(eng, tp, dp, toks, lens, s, cache_len=64, block=16):
    """Greedy (or speculative, s > 0) generation of ``eng.max_new`` tokens
    for each prompt through a paged slot pool: ``prefill_into`` each row,
    then steps until every slot is done.  Returns the tokens [B, max_new]."""
    B = toks.shape[0]
    state = eng.init_slots(B, cache_len, block_size=block)
    for b in range(B):
        state = eng.prefill_into(tp, dp, state, b, toks[b, :lens[b]], int(lens[b]), cache_len)
    while not bool(state.done.all().cpu()):
        state, _ = eng.step(tp, dp, state, s)
    return state.out[:, :eng.max_new].cpu().numpy()


def card_vs_cpu_logits(torch, np, m, tcfg, dcfg, tps, dps, toks, lens, feed):
    """Prefill logits, a ring s = 3 verify's and a paged s = 3 verify's
    (after ``prefill_into`` of each prompt), on the CPU and on the card from
    the same parameters.  Returns {name: (cpu, card)}."""
    out = {}
    for dev in ("cpu", "cuda"):
        tp, dp = tps[dev], dps[dev]
        model = m.DecoderLM(tcfg)
        t = torch.from_numpy(toks).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        f = torch.from_numpy(feed).to(dev)
        cache = model.init_cache(t.shape[0], 64, torch.float32, dev)
        pre, cache, seq = model.prefill(tp, t, cache, ln)
        ring, _ = model.decode_step(tp, f, cache, seq + 1)
        eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=8, dtype=torch.float32, device=dev)
        st = eng.init_slots(t.shape[0], 64, block_size=16)
        for b in range(t.shape[0]):
            st = eng.prefill_into(tp, dp, st, b, toks[b, :lens[b]], int(lens[b]), 64)
        cu = torch.from_numpy(m.host_cu_blocks(st.paged.device_tables())).to(dev)
        paged, _ = model.decode_step(tp, f, st.tcache, st.seq_lens, cu)
        for name, x in (("prefill", pre), ("ring_s3", ring), ("paged_s3", paged)):
            out.setdefault(name, []).append(x.float().cpu())
    return out


def moe_dispatch_check(torch, m, tcfg, lp, n=256, seed=29):
    """``moe_forward`` through both dispatches on the card, on layer 0's
    parameters and ``n`` random rows at full width, fp32: at the no-drop
    factor and at the config's 1.25 (drops asserted), outputs and aux within
    1e-5 relative, and at 1.25 the same assignments kept (the cumulative-sum
    ranks of ``einsum`` against the stable-sort dispatch's weights)."""
    mo = m.moe
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, n, tcfg.d_model), generator=g, device="cuda")
    row = {}
    for name, cfg in (("no_drop", no_drop(tcfg)), ("cf_1.25", tcfg)):
        res = {}
        for disp in ("einsum", "gather"):
            c = cfg.with_(moe=dataclasses.replace(cfg.moe, dispatch=disp))
            res[disp] = mo.moe_forward(c, lp, x)
        y_e, a_e = res["einsum"]
        y_g, a_g = res["gather"]
        mc = cfg.moe
        _, top_p, top_i = mo.route(mc, lp["router"], x)
        C = mo.capacity(n, mc.top_k, mc.n_experts, mc.capacity_factor)
        kept = mo.slot_ranks(top_i, mc.n_experts) < C
        _, _, w, _ = mo._dispatch_gather(mc, x, top_i, top_p, C)
        row[name] = dict(
            capacity=C, dropped=int((~kept).sum()), assignments=kept.numel(),
            out_rel_err=float((y_e - y_g).abs().max() / y_e.abs().max()),
            aux_rel_err=abs(float(a_e) - float(a_g)) / abs(float(a_e)),
            same_kept=bool(torch.equal(kept, w > 0)))
    ok = (all(r["out_rel_err"] <= 1e-5 and r["aux_rel_err"] <= 1e-5 and r["same_kept"]
              for r in row.values())
          and row["no_drop"]["dropped"] == 0 and row["cf_1.25"]["dropped"] > 0)
    return row, ok


def mixed_equals_flush(torch, np, m, tcfg, dcfg, tp, dp, s=3, cache_len=96, block=16):
    """One mixed verify+chunk step against the chunk's own forward then the
    step, on the card: two decoding slots and a 48-token chunk of a pending
    third.  Returns whether the tokens, counts and lengths agree."""
    rng = np.random.default_rng(31)
    v = tcfg.vocab_size
    p0, p1, long_p = (rng.integers(0, v, (n,)).astype(np.int32) for n in (21, 37, 80))
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=16, dtype=torch.float32, device="cuda")
    outs = []
    for mixed in (False, True):
        st = eng.init_slots(3, cache_len, block_size=block)
        st = eng.prefill_into(tp, dp, st, 0, p0, len(p0), cache_len)
        st = eng.prefill_into(tp, dp, st, 1, p1, len(p1), cache_len)
        st, ch = eng.prefill_chunk_into(tp, dp, st, 2, long_p[:48].copy(), 0, 48, len(long_p),
                                        defer=True)
        if mixed:
            st, stats = eng.step_with_chunk(tp, dp, st, s, ch)
        else:
            st = eng.flush_chunk(tp, dp, st, ch)
            st, stats = eng.step(tp, dp, st, s)
        outs.append([np.asarray(stats.committed)] + [
            getattr(st, k).cpu().numpy() for k in ("out", "n_generated", "seq_lens", "last2")])
    return all(np.array_equal(a, b) for a, b in zip(*outs))


def qwen_parity(torch, np, R, m, tree_to, arch):
    """9a for one config: the target and its draft cut to 2 layers at full
    width, fp32, on the same parameters on the CPU and the card."""
    f32 = torch.float32
    tcfg = R.get_config(arch).with_(n_layers=2)
    dcfg = R.get_draft_config(arch).with_(n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(19)   # drawn on the card: faster
    tp = m.DecoderLM(tcfg).init(gen, f32, "cuda")
    dp = m.DecoderLM(dcfg).init(gen, f32, "cuda")
    tp_cpu, dp_cpu = tree_to(tp, "cpu"), tree_to(dp, "cpu")
    rng = np.random.default_rng(13)
    B = 4
    toks = rng.integers(0, tcfg.vocab_size, (B, 16)).astype(np.int64)
    lens = np.array([16, 11, 14, 9], np.int32)
    feed = rng.integers(0, tcfg.vocab_size, (B, 4)).astype(np.int32)
    tol = 2e-3   # the card-against-CPU rule of phases 3 and 6e: fp32 sums in another order
    logits = card_vs_cpu_logits(torch, np, m, tcfg, dcfg, {"cpu": tp_cpu, "cuda": tp},
                                {"cpu": dp_cpu, "cuda": dp}, toks, lens, feed)
    del tp_cpu, dp_cpu
    errs = {k: float((g - c).abs().max()) for k, (c, g) in logits.items()}
    ok_logits = all(bool(((g - c).abs() <= tol + tol * c.abs()).all())
                    for c, g in logits.values())
    # K5's calls a layer, counted around one prefill on the card
    m.K5.FWD.launches = 0
    model = m.DecoderLM(tcfg)
    model.prefill(tp, torch.from_numpy(toks).cuda(), model.init_cache(B, 64, f32, "cuda"),
                  torch.from_numpy(lens).cuda())
    torch.cuda.synchronize()
    k5 = m.K5.FWD.launches
    # speculative (s 3) = greedy (s 0), ring and paged, at the no-drop factor
    eng = m.SpecDecodeEngine(no_drop(tcfg), dcfg, max_new=16, dtype=f32, device="cuda")
    lens_np = lens.astype(np.int32)
    spec = {}
    for route in ("ring", "paged"):
        got = {}
        for s in (0, 3):
            if route == "ring":
                got[s] = eng.generate(tp, dp, toks.astype(np.int32), lens_np, s=s,
                                      cache_len=64)[0]
            else:
                got[s] = paged_tokens(eng, tp, dp, toks.astype(np.int32), lens_np, s)
        spec[route] = bool(np.array_equal(got[0], got[3]))
    line = dict(arch=arch, n_layers=2, logits_max_abs_err=errs, tol=tol,
                k5_launches_prefill=k5, k5_expected=k5_per_layer(tcfg) * 2 + 1,
                spec_equals_greedy=spec)
    checks = [(ok_logits, f"{arch}: card vs CPU logits differ: {errs} (tol {tol})"),
              (k5 == line["k5_expected"], f"{arch}: K5 launched {k5} times in a 2-layer "
                                          f"prefill, not {line['k5_expected']}"),
              (all(spec.values()), f"{arch}: speculative tokens differ from greedy: {spec}")]
    if tcfg.moe is not None:
        lp0 = {k: v[0] for k, v in tp["layers"]["moe"].items()}
        line["dispatch"], ok_disp = moe_dispatch_check(torch, m, tcfg, lp0)
        line["mixed_equals_flush"] = mixed_equals_flush(torch, np, m, no_drop(tcfg), dcfg,
                                                        tp, dp)
        checks += [(ok_disp, f"{arch}: the einsum and gather dispatches disagree: "
                             f"{line['dispatch']}"),
                   (line["mixed_equals_flush"],
                    f"{arch}: the mixed step's tokens differ from flush-then-step")]
    print("  " + json.dumps({"qwen_parity": line}), flush=True)
    for cond, msg in checks:
        check(cond, msg)
    return line


def phase_qwen_parity(torch, np, R, m, tree_to):
    out = {}
    for arch in QWEN_YI:
        out[arch] = qwen_parity(torch, np, R, m, tree_to, arch)
        torch.cuda.empty_cache()
    return out


def record_router_inputs(m, rows):
    """Keep (config, router, x, the call's kind and real rows) of every
    ``moe_forward`` call until ``drop_share`` reads them (references only:
    no work on the card during the run); ``rows`` holds the kind and the
    real rows of the engine call in progress (set by the caller's
    wrappers).  Returns the list and the function that restores the
    module."""
    seen, inner = [], m.moe.moe_forward

    def recording(cfg, params, x):
        seen.append((cfg, params["router"], x, dict(rows)))
        return inner(cfg, params, x)
    m.moe.moe_forward = recording

    def restore():
        m.moe.moe_forward = inner
    return seen, restore


def drop_share(torch, m, seen):
    """Dropped assignments over all assignments of the recorded calls, from
    their router outputs (``route``, ``slot_ranks``, ``capacity``), by kind
    of call (a B = 1 prefill of a bucket-padded prompt, a step), over every
    row and over the rows that carry a token (a prefill's first
    ``prompt_len - 1`` columns; a step's live slots).  A prefill's padding
    rows come after its real ones in (t, k) order, so they take no slot a
    real row would have had; a step's idle slots can."""
    mo = m.moe
    out = {}
    for cfg, router, x, rows in seen:
        mc = cfg.moe
        B, T, d = x.shape
        tg = mo.group_size(B * T)
        _, _, top_i = mo.route(mc, router, x.reshape(-1, tg, d))
        C = mo.capacity(tg, mc.top_k, mc.n_experts, mc.capacity_factor)
        drop = (mo.slot_ranks(top_i, mc.n_experts) >= C).reshape(B, T, -1)
        if rows["kind"] == "prefill":
            real = torch.arange(T, device=x.device)[None] < rows["n"]
        else:
            real = rows["live"].to(x.device)[:, None].expand(B, T)
        o = out.setdefault(rows["kind"], dict(calls=0, dropped=0, assignments=0,
                                              dropped_real=0, assignments_real=0))
        o["calls"] += 1
        o["dropped"] += int(drop.sum())
        o["assignments"] += drop.numel()
        o["dropped_real"] += int(drop[real].sum())
        o["assignments_real"] += int(real.sum()) * drop.shape[2]
    for o in out.values():
        o["share"] = o["dropped"] / max(o["assignments"], 1)
        o["share_real"] = o["dropped_real"] / max(o["assignments_real"], 1)
    tot = {k: sum(o[k] for o in out.values()) for k in ("dropped", "assignments",
                                                       "dropped_real", "assignments_real")}
    return dict(out, share=tot["dropped"] / max(tot["assignments"], 1),
                share_real=tot["dropped_real"] / max(tot["assignments_real"], 1))


def qwen_serve(torch, np, R, m, arch):
    """9b for one config: full size in bf16 with its dense draft."""
    import copy
    bf16 = torch.bfloat16
    tcfg, dcfg = R.get_config(arch), R.get_draft_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # sampled (random weights accept nothing greedily): the grid and the
    # serving run; the step profiles run on a twin with room for 64 tokens
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=32, dtype=bf16, device="cuda", sample=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    eng.load_kernels(paged=True)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in m.leaves(tp))
    line = dict(arch=arch, weights_gb=weight_bytes / 1e9, init_s=time.perf_counter() - t0,
                weight_floor_ms=1e3 * weight_bytes / HBM_BYTES_PER_S)
    # ---- the per-token latency grid and its LUT ----
    rng = np.random.default_rng(1)
    sample = m.synthetic_prompts(8, tcfg.vocab_size, rng, 8, 16)
    toks = np.zeros((8, max(len(p) for p in sample)), np.int32)
    lens = np.array([len(p) for p in sample], np.int32)
    for i, p in enumerate(sample):
        toks[i, :len(p)] = p
    t0 = time.perf_counter()
    lut = m.profile_engine(eng, tp, dp, toks, lens, batch_sizes=(1, 8, 16), s_values=(0, 3),
                           gen_tokens=16, cache_len=256)
    line.update(grid_s=time.perf_counter() - t0,
                grid_ms_per_token={b: {s: 1e3 * t for s, t in d.items()}
                                   for b, d in lut.per_token.items()},
                lut=dict(lut.table))
    torch.cuda.empty_cache()
    # ---- the pool: as many blocks of 16 as memory allows, up to the worst case ----
    a = tcfg.attn
    per_block = tcfg.n_layers * 2 * 16 * a.n_kv_heads * a.head_dim * 2
    free = torch.cuda.mem_get_info()[0]
    blocks = int(min(16 * 512 // 16, (free - 6e9) // per_block))
    line["blocks"] = blocks
    check(blocks >= 144, f"{arch}: {blocks} blocks of 16 fit the card, fewer than 144")
    # ---- serve_continuous_live, sampled, 16 requests of phase 6b's trace ----
    rec = dict(prefills=0, s=[], accepted=0, proposed=0)
    pi, st = eng.prefill_into, eng.step
    rows = {"kind": None}     # the engine call in progress, for drop_share

    def prefill_into(*a_, **kw):
        if not kw.get("warm"):
            rec["prefills"] += 1
            # the target's prefill feeds prompt_len - 1 rows
            rows.update(kind="prefill", n=(a_[5] if len(a_) > 5 else kw["prompt_len"]) - 1)
        return pi(*a_, **kw)

    def step(*a_, **kw):
        if tcfg.moe is not None and not kw.get("warm"):
            rows.update(kind="step", live=~a_[2].done.cpu())
        out = st(*a_, **kw)
        if not kw.get("warm"):
            s = a_[3] if len(a_) > 3 else kw["s"]
            live = out[1].committed > 0
            rec["s"].append(s)
            rec["accepted"] += int(out[1].accepted[live].sum())
            rec["proposed"] += s * int(live.sum())
        return out
    eng.prefill_into, eng.step = prefill_into, step
    ctrl = m.AdaptiveController(lut=m.SpeculationLUT(dict(lut.table)))
    reqs = continuous_requests(np, m.Request, tcfg.vocab_size, 16, (64, 192), 32, 0.05, 23)
    be = m.ContinuousEngineBackend(eng, tp, dp, capacity=16, cache_len=512, block_size=16,
                                   num_blocks=blocks, collect_outputs=True,
                                   warm_s=sorted(set(lut.table.values())),
                                   s_cap=m.controller_s_cap(ctrl))
    seen, restore = (record_router_inputs(m, rows) if tcfg.moe is not None
                     else ([], lambda: None))
    torch.cuda.synchronize()
    zero_counts(m)
    t0 = time.perf_counter()
    try:
        res = m.serve_continuous_live(copy.deepcopy(reqs), eng, tp, dp, ctrl, backend=be)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = launch_counts(m)
    want = predicted_launches(tcfg, dcfg, rec["prefills"], rec["s"])
    done = [r for r in res.requests if r.finish is not None and r.n_generated == r.max_new]
    outs = [np.asarray(be.outputs[r.rid]) for r in res.requests if r.rid in be.outputs]
    in_vocab = bool(outs) and all(o.size and 0 <= o.min() and o.max() < tcfg.vocab_size
                                  for o in outs)
    line["serve"] = dict(requests=len(reqs), finished=len(done), **serve_line(m, res, wall),
                         admissions=rec["prefills"], steps_by_s={
                             int(s): rec["s"].count(s) for s in sorted(set(rec["s"]))},
                         acceptance=rec["accepted"] / max(rec["proposed"], 1),
                         launches=launches, predicted=want, tokens_in_vocab=in_vocab)
    if tcfg.moe is not None:
        line["serve"]["moe_drops_cf_1.25"] = drop_share(torch, m, seen)
    del seen, be, res
    eng.__dict__.pop("prefill_into")
    eng.__dict__.pop("step")
    torch.cuda.empty_cache()
    # ---- step profiles at B 16, s 0 and 3, on a paged pool ----
    eng = m.SpecDecodeEngine(tcfg, dcfg, max_new=64, dtype=bf16, device="cuda", sample=True)
    state = eng.init_slots(16, 512, block_size=16, num_blocks=blocks)
    ptoks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (16, 128)).astype(np.int32)
    for slot in range(16):
        state = eng.prefill_into(tp, dp, state, slot, ptoks[slot], 128, 512)
    prof = {}
    for s in (0, 3):
        keep = []
        r = profile_step(torch, eng, tp, dp, f"{arch}_paged_b16_s{s}", state, s, keep=keep,
                         host=False)
        state = keep[0]
        busy = r["device_busy_ms"]
        prof[f"paged_b16_s{s}"] = dict(
            wall_ms=r["wall_ms"], device_busy_ms=busy, idle_share=r["idle_share"],
            device_kernels=r["device_kernels"], top5_device_ms=dict(
                list(r["top_device_ms"].items())[:5]),
            k3_share=r["paged_kernel_ms"] / busy if busy else None,
            k5_share=r["k5_ms"] / busy if busy else None,
            k3_device_kernels=r["paged_device_kernels"], k5_launches=r["k5_launches"],
            profile_takes=r["profile_takes"], profile_lost=r["profile_lost"])
    line["profiles"] = prof
    line["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    line["card_memory_gb"] = torch.cuda.get_device_properties(0).total_memory / 1e9
    del state, eng, tp, dp
    torch.cuda.empty_cache()
    print("  " + json.dumps({"qwen_serve": line}, default=float), flush=True)
    sv = line["serve"]
    check(sv["finished"] == len(reqs), f"{arch}: {len(reqs) - sv['finished']} requests did "
                                       "not finish")
    check(in_vocab, f"{arch}: a generated token lies outside the true vocabulary")
    check(all(launches[k] == want[k] for k in ("k1", "k3", "k5")),
          f"{arch}: launches {launches} differ from the prediction {want}")
    check(launches["plain"] == 0, f"{arch}: a plain version ran on the card")
    check(line["peak_memory_gb"] < line["card_memory_gb"], f"{arch}: peak memory over the card")
    return line


def phase_qwen_serve(torch, np, R, m):
    return {arch: qwen_serve(torch, np, R, m, arch) for arch in QWEN_YI}


def train_kernel_rows(trows, launches, k5_serve, k5_live, distill, pflash, mamba_launches):
    """The ``kernels`` line's K4 and K5 rows, forward and backward, at the
    trainer's shapes (internlm2-1.8b, fp32), with the trainer's launches
    (K5's also with the Mamba-2 trainer's),
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
    out[2]["plan"] = norm["fwd_plan"]
    out[2]["launches_serving"] = {"phase 4": k5_serve, "phase 6b": k5_live}
    out[2]["launches_mamba_train"] = mamba_launches["k5_fwd"]   # 97 a step
    out[3]["launches_mamba_train"] = mamba_launches["k5_bwd"]
    out[0]["launches_distill"] = distill["launches"]["k4_fwd"]
    out.insert(1, {"name": "flash_attn_fwd_bf16", **{k: out[0][k] for k in (
        "route", "source", "replaces")}, "launches": pflash["k4_launches_bf16"],
        "launches_from": "phase 7, prefill_flash on OPT-6.7B in bf16 (one per layer)",
        "max_abs_err": pre["max_abs_err"], "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": pre["library_ms"], "library": "SDPA", "shape": f"{pre['shape']}, bf16"})
    return out


def ssd_kernel_row(srows, launches, launches_live, launches_train):
    """The ``kernels`` line's K6 row at the continuous path's largest
    prefill (B 1, T 256, bf16), with the launches of phase 8's serve loop
    (the main path), of its continuous run and of phase 7's Mamba-2
    trainer."""
    r = next(r for r in srows if r["case"] == "ssd_serve_b1_t256_bf16")
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:52", "launches": launches,
            "launches_from": "phase 8, the mamba2-1.3b serve loop",
            "launches_continuous": launches_live, "launches_mamba_train": launches_train,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "library": "none", "shape": r["shape"] + ", bf16",
            "device_kernels_per_call": r["device_kernels"]}


def ssd_bwd_kernel_row(brows, mtrain):
    """The ``kernels`` line's row for K6's backward at the mamba2-1.3b
    trainer's call (B 4, T 512, fp32), with the launches of phase 7's
    Mamba-2 trainer (the main path: once per layer a step)."""
    r = next(r for r in brows if r["case"] == "ssd_bwd_train_b4_t512_f32")
    bf = next(r for r in brows if r["case"] == "ssd_bwd_train_b4_t512_bf16")
    return {"name": "ssd_chunk_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:52",
            "replaces_note": "the TPU kernel has no backward; JAX differentiates the plain "
                             "Mamba2LM._ssd_chunked (src/repro/models/mamba2.py:141)",
            "launches": mtrain["launches"]["k6_bwd"],
            "launches_from": "phase 7, the mamba2-1.3b trainer (20 steps)",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_simt_ms": r["bound_simt_ms"], "library_ms": None, "library": "none",
            "shape": r["shape"] + ", fp32", "device_kernels_per_call": r["device_kernels"],
            "bf16": {k: bf[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err", "tol")}}


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
    from repro_torch.core import spec_decode
    from repro_torch.core.spec_decode import SpecDecodeEngine
    from repro_torch import training
    from repro_torch.kernels import build, ops, paged, ref, tuning
    from repro_torch.kernels import flash_attn as K4
    from repro_torch.kernels import paged_verify_attn as K23
    from repro_torch.kernels import rmsnorm as K5
    from repro_torch.kernels import spec_verify_attn as K1
    from repro_torch.kernels import ssd_chunk as K6
    from repro_torch.launch import serve, train
    from repro_torch.models import moe
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.serving import metrics, scheduler
    from repro_torch.serving.prefix_cache import PrefixCache
    from repro_torch.serving.request import Request
    from repro_torch.serving.telemetry import Telemetry
    from repro_torch.serving.traffic import synthetic_prompts
    from repro_torch.training import train_step
    from repro_torch.training.optimizer import leaves

    # what phases 6 and 7 drive, under one name
    m = types.SimpleNamespace(
        SpecDecodeEngine=SpecDecodeEngine, spec_decode=spec_decode, Request=Request, K1=K1,
        K23=K23, K4=K4, K5=K5, K6=K6, serve=serve, Telemetry=Telemetry,
        synthetic_prompts=synthetic_prompts, profile_engine=adaptive.profile_engine,
        ops=ops, paged=paged, host_cu_blocks=tuning.host_cu_blocks,
        grid_steps_ragged=tuning.grid_steps_ragged,
        grid_steps_dense=tuning.grid_steps_dense,
        AdaptiveController=adaptive.AdaptiveController,
        SpeculationLUT=adaptive.SpeculationLUT, fixed_controller=adaptive.fixed_controller,
        LatencyModel=analytical.LatencyModel,
        ContinuousEngineBackend=scheduler.ContinuousEngineBackend,
        ContinuousScheduler=scheduler.ContinuousScheduler,
        SimStepBackend=scheduler.SimStepBackend, replay_sources=scheduler.replay_sources,
        PrefixCache=PrefixCache,
        serve_continuous_live=scheduler.serve_continuous_live,
        PrefillBudgetAdmit=scheduler.PrefillBudgetAdmit,
        controller_s_cap=scheduler.controller_s_cap,
        ttft_summary=metrics.ttft_summary, itl_summary=metrics.itl_summary,
        goodput=metrics.goodput, mean_occupancy=metrics.mean_occupancy,
        R=R, DecoderLM=DecoderLM, train=train, measure_acceptance=adaptive.measure_acceptance,
        DataConfig=training.DataConfig, batch_at=training.batch_at,
        AdamWConfig=training.AdamWConfig, init_adamw=training.init_adamw,
        adamw_update=training.adamw_update, make_train_step=training.make_train_step,
        make_loss_fn=training.make_loss_fn, make_distill_step=training.make_distill_step,
        value_and_grad=train_step.value_and_grad, moe=moe, leaves=leaves)

    def tree_to(tree, device):
        return tree_map(lambda t: t.to(device), tree)

    t_all = time.perf_counter()
    t_phase = [t_all]

    def done(phase, **kw):
        """A phase's report line, with the seconds since the last one."""
        now = time.perf_counter()
        print(json.dumps({"phase": phase, "ok": True, **kw, "s": now - t_phase[0]}),
              flush=True)
        t_phase[0] = now
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
    # every forward instance fwd_plan can name is in the library (a query
    # for a missing one raises), and the blocks an SM at phase 2c's plans
    k5_fwd_built = {f"{dt}_vec{vec}_c{c}": K5.fwd_occupancy(getattr(torch, dt), dict(
        vec=vec, chunks=c, lanes=32, gpb=1))
        for dt in ("float32", "bfloat16") for vec in (16 // getattr(torch, dt).itemsize, 1)
        for c in K5.FWD_CHUNKS[vec]}
    print("  k5 forward instances built (blocks an SM at 32 threads): "
          + json.dumps(k5_fwd_built), flush=True)
    print("  k5 forward occupancy (blocks an SM at the plans of phase 2c's cases): "
          + json.dumps({name: dict(plan={k: plan[k] for k in K5.FWD_ARGS},
                                   blocks_per_sm=K5.fwd_occupancy(getattr(torch, dt), plan))
                        for name, n, d, dt, _ in NORM_CASES
                        for plan in [K5.fwd_plan(n, d, getattr(torch, dt).itemsize)]}),
          flush=True)
    print("  k6 occupancy (mamba2-1.3b, plans at B 8 T 16, B 1 T 256, B 4 T 2048): "
          + json.dumps({f"{dt}_b{b}_t{t}": dict(plan=plan, **K6.occupancy(
              getattr(torch, dt), 64, 128, t, q, 64, 1, plan))
              for dt in ("float32", "bfloat16") for b, t, q in ((8, 16, 16), (1, 256, 256),
                                                                (4, 2048, 256))
              for plan in [K6.ssd_plan(b, t, 64, 1, 64, 128, q, sms)]}), flush=True)
    print("  k6 backward occupancy (P 64, N 128, Q 256): " + json.dumps({
        dt: K6.bwd_occupancy(getattr(torch, dt), 64, 128, 256)
        for dt in ("float32", "bfloat16")}), flush=True)

    # ---- 2. kernels ----
    rows = phase_kernels(torch, K1, ref)
    done("kernels", cases=len(rows))

    # ---- 2b. paged kernels ----
    prows = phase_paged_kernels(torch, np, K23, paged, ref)
    done("paged_kernels", cases=len(prows))
    torch.cuda.empty_cache()

    # ---- 2c. K4 and K5, forward and backward ----
    trows = phase_train_kernels(torch, K4, K5, ref)
    done("train_kernels", cases=len(trows))
    torch.cuda.empty_cache()

    # ---- 2d. K6, the SSD scan ----
    srows = phase_ssd_kernels(torch, K6, ref)
    done("ssd_kernels", cases=len(srows))
    torch.cuda.empty_cache()
    brows = phase_ssd_bwd_kernels(torch, K6, ops, ref)
    done("ssd_bwd_kernels", cases=len(brows))
    torch.cuda.empty_cache()

    # ---- 3. fp32 parity, card against CPU ----
    phase_parity(torch, np, R, DecoderLM, SpecDecodeEngine, tree_to)
    done("parity")
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
    print(json.dumps({"phase": "serve", **res, "s": time.perf_counter() - t_phase[0]}),
          flush=True)
    t_phase[0] = time.perf_counter()
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
    done("profile")
    torch.cuda.empty_cache()

    # ---- 6a. continuous parity, fp32; K2's path: the paged decode_step ----
    cont = phase_continuous_parity(torch, np, R, m)
    done("continuous_parity")
    torch.cuda.empty_cache()

    # ---- 6b. the continuous main path, bf16, full depth ----
    live = phase_continuous_serve(torch, np, R, m, res["lut"])
    done("continuous_serve")
    torch.cuda.empty_cache()

    # ---- 6c. chunked prefill on the continuous main path, bf16, full depth ----
    chunked = phase_chunked_serve(torch, np, R, m, res["lut"])
    done("chunked_serve")
    torch.cuda.empty_cache()

    # ---- 6d. the prefix cache on the continuous main path, bf16, full depth ----
    prefix = phase_prefix_serve(torch, np, R, m, res["lut"])
    done("prefix_serve")
    torch.cuda.empty_cache()

    # ---- 6e. the int8 KV cache (kv_quant) on the continuous main path ----
    kvq = phase_kv_quant(torch, np, R, m, res["lut"], live, tree_to)
    done("kv_quant")
    torch.cuda.empty_cache()

    # ---- 6f. stochastic speculative sampling (sample=True) ----
    phase_sampling(torch, np, R, m, tree_to)
    done("sampling")
    torch.cuda.empty_cache()

    # ---- 6g. the telemetry hub on the continuous main path ----
    phase_telemetry(torch, np, R, m)
    done("telemetry")
    torch.cuda.empty_cache()

    # ---- 7. the training path: distillation, the trainer, card vs CPU, prefill_flash ----
    distill = phase_distill(torch, np, R, m)
    done("distill")
    torch.cuda.empty_cache()
    trained = phase_train(torch, m)
    done("train")
    torch.cuda.empty_cache()
    phase_train_parity(torch, np, m, tree_to)
    done("train_parity")
    torch.cuda.empty_cache()
    mtrain = phase_mamba_train(torch, m)
    done("mamba_train")
    torch.cuda.empty_cache()
    phase_mamba_train_parity(torch, np, m, tree_to)
    done("mamba_train_parity")
    torch.cuda.empty_cache()
    pflash = phase_prefill_flash(torch, np, R, m)
    done("prefill_flash")
    torch.cuda.empty_cache()

    # ---- 8. Mamba-2: card vs CPU, the serve loop and the continuous runtime ----
    phase_mamba_parity(torch, np, m, tree_to)
    done("mamba_parity")
    torch.cuda.empty_cache()
    mserve = phase_mamba_serve(torch, m)
    torch.cuda.empty_cache()
    mlive = phase_mamba_continuous(torch, np, m, mserve["lut"])
    done("mamba_continuous")
    torch.cuda.empty_cache()

    # ---- 9. qwen3-8b, yi-34b and qwen3-moe-30b-a3b: card vs CPU, then full size ----
    phase_qwen_parity(torch, np, R, m, tree_to)
    done("qwen_parity")
    qserve = phase_qwen_serve(torch, np, R, m)
    done("qwen_serve")
    qlaunch = {a: q["serve"]["launches"] for a, q in qserve.items()}

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
    k1_int8 = [{k: r[k] for k in keys} for r in rows
               if r["case"].startswith("cont_") and "_int8_" in r["case"]]
    k3_int8 = [{k: r[k] for k in keys} for r in prows
               if r["case"].startswith("opt_pool_full_t1_int8")]
    q8_launches = kvq["serve"]["runs"]["int8"]["launches"]
    q8_from = (f"phase 6e, serve_continuous_live on the "
               f"{kvq['serve']['runs']['int8']['blocks']}-block int8 pool")
    phead = next(r for r in prows if r["case"] == "opt_pool_full_t1_bf16")
    paged_shape = "target verify s=0, " + phead["shape"] + ", bf16"
    paged_common = {"max_abs_err": phead["max_abs_err"], "plain_ms": phead["plain_ms"],
                    "bound_ms": phead["bound_ms"], "bound_by": phead["bound_by"],
                    "library_ms": phead["library_ms"], "library": phead["library"],
                    "n_splits": phead["n_splits"],
                    "device_kernels_per_call": phead["device_kernels"], "shape": paged_shape}
    kernels = [{
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
        "launches_prefix": {k: prefix[k]["launches"]["k1"]
                            for k in ("cold", "cache", "cache_chunked")},
        "launches_int8": q8_launches["k1_int8"], "launches_int8_from": q8_from,
        "int8": k1_int8,
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
        "launches_prefix": {k: prefix[k]["launches"]["k3"]
                            for k in ("cold", "cache", "cache_chunked")},
        "launches_int8": q8_launches["k3_int8"], "launches_int8_from": q8_from,
        "int8": k3_int8,
        **paged_common}] + train_kernel_rows(trows, trained["launches"], k5_serve,
                                             live["launches"]["k5"], distill, pflash,
                                             mtrain["launches"])
    kernels += [ssd_kernel_row(srows, mserve["launches"]["k6"], mlive["launches"]["k6"],
                               mtrain["launches"]["k6_fwd"]),
                ssd_bwd_kernel_row(brows, mtrain)]
    # phase 9b's launches on the three configs' paged serving runs, and K5's
    # rows at qk_norm's per-head width
    for row in kernels:
        key = {"spec_verify_attn": "k1", "ragged_paged_verify_attn": "k3",
               "rmsnorm_fwd": "k5"}.get(row["name"])
        if key:
            row["launches_qwen_yi"] = {a: q[key] for a, q in qlaunch.items()}
            row["launches_qwen_yi_from"] = "phase 9b, serve_continuous_live at full size"
        if row["name"] == "rmsnorm_fwd":
            row["qk_norm"] = [{k: r[k] for k in ("case", "shape", "dtype", "max_abs_err", "ms",
                                                 "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "fwd_plan", "row_independent")}
                              for r in trows if r["case"].startswith(("rmsnorm_qwen3",
                                                                      "rmsnorm_qk_norm"))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
