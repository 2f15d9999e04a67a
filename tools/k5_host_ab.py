#!/usr/bin/env python3
"""Two checkouts of the port on one GPU, in turns: the host's cost of K5's
forward wrapper and the full-size Qwen3 / Yi serving steps it runs in.

    python3 tools/k5_host_ab.py --other DIR [--pairs N] [--configs A,B] [--norm-cases]   # on a GPU

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a gitignored directory).  The
runs go other, this, this, other, ... (``N`` pairs), each in a process of
its own that imports that checkout's ``chip_smoke.py`` and ``src/`` and
builds that checkout's kernels.  A run measures:

- the host's time a call of K5's forward wrapper (``rmsnorm_fwd_cuda``) at
  the rows of a qwen3-8b B 16 decode step (``qk_norm``'s q and k rows, and
  a layer norm's), and of ``F.rms_norm`` on the same inputs (a library call
  neither checkout changes: the host's own speed in that run), with the
  card held busy by a sleeping kernel so that only the host's work is
  timed; and a fixed pure-Python loop, the host's speed without the card;
- for each config (by default phase 9b's three: qwen3-8b, yi-34b,
  qwen3-moe-30b-a3b, full size in bf16 with random weights, sampled), the
  paged B 16 step at s 0 after 128-token prompts, as phase 9b profiles it:
  the wall time a step over three rounds of 8 unprofiled steps, then
  ``chip_smoke.profile_step``'s device time, idle share and K5 time
  (``--configs ""``: none);
- with ``--norm-cases``, phase 2c's K5 cases (this checkout's
  ``chip_smoke.NORM_CASES``) through that checkout's
  ``chip_smoke.run_norm_case``: its forward's device time a call against
  ``F.rms_norm``'s, with its gates; then the forward timed again over
  input sets rotated as ``run_norm_case`` rotates them and as
  ``tools/rmsnorm_variants.py`` does.

One JSON line per run, the card's name and power limit first; everything
also goes to ``chiprun_out/k5_host_ab.log``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "AB_RESULT "   # tools/paged_serve_ab.run_turns reads the line it starts
CONFIGS = ("qwen3-8b", "yi-34b", "qwen3-moe-30b-a3b")
# qwen3-8b's K5 forward calls in a B 16 decode step at s 0: q_norm's rows
# (16 tokens x 32 heads), k_norm's (16 x 8), a layer norm's (16 x 4096)
HOST_SHAPES = (("q_norm_512x128", 512, 128), ("k_norm_128x128", 128, 128),
               ("norm_16x4096", 16, 4096))


def host_us(torch, fn, calls=400, rounds=5) -> float:
    """Median over ``rounds`` of the host's microseconds a call of ``fn``,
    queued behind a sleeping kernel (the card never makes the host wait)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return sorted(out)[rounds // 2]


def python_loop_ms() -> float:
    """The host's speed alone: the best of three runs of a fixed loop."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(1_000_000):
            acc += i * i
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def step_walls(torch, np, R, SpecDecodeEngine, cs, arch) -> dict:
    """Phase 9b's paged B 16 step at s 0 for ``arch``: the state built as
    ``chip_smoke.qwen_serve`` builds it for its profiles."""
    bf16 = torch.bfloat16
    tcfg, dcfg = R.get_config(arch), R.get_draft_config(arch)
    eng = SpecDecodeEngine(tcfg, dcfg, max_new=64, dtype=bf16, device="cuda", sample=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tp = eng.target.init(gen, bf16, "cuda")
    dp = eng.draft.init(gen, bf16, "cuda")
    eng.load_kernels(paged=True)
    torch.cuda.synchronize()
    a = tcfg.attn
    per_block = tcfg.n_layers * 2 * 16 * a.n_kv_heads * a.head_dim * 2
    blocks = int(min(512, (torch.cuda.mem_get_info()[0] - 6e9) // per_block))
    state = eng.init_slots(16, 512, block_size=16, num_blocks=blocks)
    ptoks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (16, 128)).astype(np.int32)
    for slot in range(16):
        state = eng.prefill_into(tp, dp, state, slot, ptoks[slot], 128, 512)
    for _ in range(2):
        state, _ = eng.step(tp, dp, state, 0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(8):
            state, _ = eng.step(tp, dp, state, 0)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / 8)
    r = cs.profile_step(torch, eng, tp, dp, f"{arch}_paged_b16_s0", state, 0, host=False)
    del state, eng, tp, dp
    torch.cuda.empty_cache()
    wall = sorted(walls)[1]
    return {"wall_ms": wall, "wall_ms_rounds": walls, "blocks": blocks,
            "idle_share": 1.0 - r["device_busy_ms"] / wall, "profile_wall_ms": r["wall_ms"],
            **{k: r[k] for k in ("device_busy_ms", "k5_ms", "k5_launches", "device_kernels")}}


def worker(checkout: str, configs, norm_cases) -> int:
    """One run in ``checkout``: the wrapper's host time, the steps, then
    ``norm_cases`` (name, n, d, dtype, grads) through its phase 2c."""
    sys.path.insert(0, os.path.join(checkout, "src"))
    sys.path.insert(0, checkout)
    import numpy as np
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.configs import registry as R
    from repro_torch.core.spec_decode import SpecDecodeEngine
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rmsnorm as K5

    build.build(["spec_verify_attn", "paged_verify_attn", "rmsnorm"] if configs
                else ["rmsnorm"])
    out = {"python_loop_ms": python_loop_ms()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, n, d in HOST_SHAPES:
        x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.ones(d, device="cuda", dtype=torch.bfloat16)
        out[f"k5_host_us_{name}"] = host_us(torch, lambda: K5.rmsnorm_fwd_cuda(x, g))
        out[f"rms_norm_host_us_{name}"] = host_us(
            torch, lambda: F.rms_norm(x, (d,), g, 1e-6))
    out["steps"] = {arch: step_walls(torch, np, R, SpecDecodeEngine, cs, arch)
                    for arch in configs}
    out["norm_cases"] = {}
    fwd = lambda x_, gm, *_: K5.rmsnorm_fwd_cuda(x_, gm, save_rstd=True)  # noqa: E731
    for i, (name, n, d, dtype, grads) in enumerate(norm_cases):
        row = cs.run_norm_case(torch, K5, ref, f"rmsnorm_{name}", n, d, dtype, grads, 100 + i)
        out["norm_cases"][name] = {k: row.get(k) for k in ("ms", "library_ms", "max_abs_err",
                                                           "ok", "row_independent")}
        # the forward timed again after the case, over sets of (x, gamma, dy,
        # rstd) as run_norm_case rotates them and over sets of (x, gamma)
        # alone as tools/rmsnorm_variants.py does
        dt = getattr(torch, dtype)
        x = (3 * torch.randn((n, d), generator=gen, device="cuda")).to(dt)
        g = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dt)
        dy, rstd = torch.randn_like(x), torch.empty((n,), device="cuda")
        copies = min(64, max(2, -(-2 * 50_000_000 // (3 * n * d * x.element_size()))))
        for key, ts in (("ms_four_tensor_sets", (x, g, dy, rstd)), ("ms_two_tensor_sets", (x, g))):
            sets = [tuple(t.clone() for t in ts) for _ in range(copies)]
            out["norm_cases"][name][key] = cs.device_ms(torch, fwd, sets)
            del sets
    print(MARK + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--norm-cases", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--cases", help=argparse.SUPPRESS)
    args = ap.parse_args()
    configs = [c for c in args.configs.split(",") if c]
    import torch
    if not torch.cuda.is_available():
        print("k5_host_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker, configs, json.loads(args.cases or "[]"))
    if not args.other or not os.path.isfile(os.path.join(args.other, "chip_smoke.py")):
        print("k5_host_ab: --other must name a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tools.paged_serve_ab import run_turns
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "k5_host_ab.log"), "w")
    sys.stdout = cs.Tee(sys.stdout, log)
    print(cs.smi(), flush=True)
    cases = json.dumps(cs.NORM_CASES if args.norm_cases else [])
    return run_turns(os.path.abspath(__file__), args.other, args.pairs,
                     ["--configs", ",".join(configs), "--cases", cases])


if __name__ == "__main__":
    sys.exit(main())
