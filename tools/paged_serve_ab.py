#!/usr/bin/env python3
"""Two checkouts of the port on one GPU, in turns: the paged serving step and
the continuous runtime, end to end.

    python3 tools/paged_serve_ab.py --other DIR [--pairs N]   # repository root, on a GPU

``DIR`` is another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a gitignored directory).  The
runs go other, this, this, other, ... (``N`` pairs), each in a process of
its own that imports that checkout's ``chip_smoke.py`` and ``src/`` and
builds that checkout's kernels.  A run measures:

- ``chip_smoke.phase_profile``: one engine step of the full-width OPT-6.7B
  + OPT-125M pair in bf16 at B 8 on the ring cache (s 0 and 3; no paged
  kernel runs there, so these steps show how fast the host is in that run)
  and at B 16 on a paged pool (s 0): wall time against the device time
  ``torch.profiler`` sees;
- ``chip_smoke.phase_continuous_serve``: ``serve_continuous_live`` on a
  144-block paged pool in bf16, 32 requests, with a LUT of s = 0 at every
  batch size (what phase 4's LUT holds with random weights): TTFT, ITL,
  tokens per second;
- the host's time per call of K3's wrapper at the paged step's shape
  (B 16, T 1, 32 x 128, 9 blocks of 16 a slot, bf16), with the card held
  busy by a sleeping kernel so that only the host's work is timed.

One JSON line per run, the card's name and power limit first; everything
also goes to ``chiprun_out/paged_serve_ab.log``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT = {1: 0, 2: 0, 4: 0, 8: 0}
MARK = "AB_RESULT "


def worker(checkout: str) -> int:
    """One run in ``checkout``: the step profile, then the continuous runtime."""
    sys.path.insert(0, os.path.join(checkout, "src"))
    sys.path.insert(0, checkout)
    import types

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import registry as R
    from repro_torch.core import adaptive
    from repro_torch.core.spec_decode import SpecDecodeEngine
    from repro_torch.kernels import build, ops, paged, tuning
    from repro_torch.kernels import paged_verify_attn as K23
    from repro_torch.kernels import rmsnorm as K5
    from repro_torch.kernels import spec_verify_attn as K1
    from repro_torch.serving import metrics, scheduler
    from repro_torch.serving.request import Request

    build.build(["spec_verify_attn", "paged_verify_attn", "rmsnorm"])
    m = types.SimpleNamespace(
        SpecDecodeEngine=SpecDecodeEngine, Request=Request, K1=K1, K23=K23, K5=K5, ops=ops,
        paged=paged, host_cu_blocks=tuning.host_cu_blocks,
        grid_steps_ragged=tuning.grid_steps_ragged, grid_steps_dense=tuning.grid_steps_dense,
        AdaptiveController=adaptive.AdaptiveController, SpeculationLUT=adaptive.SpeculationLUT,
        serve_continuous_live=scheduler.serve_continuous_live,
        ttft_summary=metrics.ttft_summary, itl_summary=metrics.itl_summary,
        goodput=metrics.goodput, mean_occupancy=metrics.mean_occupancy)
    c = cs.make_paged_case(torch, np, "host", B=16, T=1, H=32, KVH=32, hd=128, bs=16,
                           MAXB=32, ctx=[140] * 16, dtype="bfloat16")
    args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["bt"], c["cu"])
    for _ in range(20):
        K23.ragged_paged_verify_attn_cuda(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(200):
        K23.ragged_paged_verify_attn_cuda(*args)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    steps = cs.phase_profile(torch, np, R, SpecDecodeEngine)
    torch.cuda.empty_cache()
    live = cs.phase_continuous_serve(torch, np, R, m, LUT)
    keep = ("wall_ms", "device_busy_ms", "idle_share", "paged_kernel_ms")
    print(MARK + json.dumps({
        "host_us_per_k3_call": host_us,
        "steps": {name: {k: row[k] for k in keep} for name, row in steps.items()},
        "continuous": {"ttft_mean_s": live["ttft"]["mean"], "ttft_p50_s": live["ttft"]["p50"],
                       "itl_mean_s": live["itl"]["mean"], "itl_p50_s": live["itl"]["p50"],
                       "tokens_per_s": live["tokens_per_s"], "goodput": live["goodput"],
                       "preemptions": live["preemptions"], "wall_s": live["wall_s"],
                       "k3_launches": live["launches"]["k3"]}}), flush=True)
    return 0


def run_turns(script: str, other: str, pairs: int, worker_args=()) -> int:
    """``script --worker CHECKOUT *worker_args`` for ``other`` and this
    checkout in turns (other, this, this, other, ...: ``pairs`` pairs), each
    in a process of its own started in that checkout; prints one JSON line
    a run from the worker's last ``MARK`` line, or its failure.  Returns 1
    if a run failed, else 0."""
    sides = {"other": os.path.abspath(other), "this": ROOT}
    order = [s for i in range(pairs)
             for s in (("other", "this") if i % 2 == 0 else ("this", "other"))]
    rc = 0
    for i, side in enumerate(order):
        proc = subprocess.run([sys.executable, script, "--worker", sides[side], *worker_args],
                              cwd=sides[side], capture_output=True, text=True)
        lines = [ln[len(MARK):] for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode or not lines:
            print(json.dumps({"run": i, "side": side, "failed": proc.returncode,
                              "tail": (proc.stdout + proc.stderr)[-3000:]}), flush=True)
            rc = 1
            continue
        print(json.dumps({"run": i, "side": side, "checkout": sides[side],
                          **json.loads(lines[-1])}), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        return worker(args.worker)
    if not args.other or not os.path.isfile(os.path.join(args.other, "chip_smoke.py")):
        print("paged_serve_ab: --other must name a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log = open(os.path.join(ROOT, "chiprun_out", "paged_serve_ab.log"), "w")
    sys.stdout = cs.Tee(sys.stdout, log)
    print(cs.smi(), flush=True)
    return run_turns(os.path.abspath(__file__), args.other, args.pairs)

if __name__ == "__main__":
    sys.exit(main())
