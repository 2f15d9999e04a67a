#!/usr/bin/env python3
"""K4 (``src/repro_torch/kernels/csrc/flash_attn.cu``) at ``chip_smoke.py``'s
phase 2c cases, alone, from this tree or from another checkout of the repo.

    python3 tools/k4_cases.py                          # every FLASH_CASES row
    python3 tools/k4_cases.py --cases gqa_g8,dsv2_train
    python3 tools/k4_cases.py --root build/parent --log chiprun_out/k4_parent.log

``--root`` names the checkout whose ``chip_smoke.py`` and ``src/`` are used
(default: this one): its flash_attn library is built into its own
``build/kernels/``, its ``FLASH_CASES`` are run with their own seeds
(``200 + index``, as phase 2c gives them) through its ``run_flash_case``,
and each row is printed as one JSON line after the card's name and power
limit, the ptxas report of K4's kernels (registers, spills) and the
forward's and backward's blocks per SM.  Two checkouts run one after the
other on one card (parent, change, change, parent) compare a change of the
source with its parent at equal inputs: a row's errors are the same to the
bit where the kernels compute the same bits.  Everything also goes to
``--log``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cases", default="", help="comma-separated FLASH_CASES names (all if empty)")
    ap.add_argument("--log", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k4_cases: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        sys.stdout = cs.Tee(sys.__stdout__, open(args.log, "w"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attn as K4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"root": root, "card": cs.smi(), "torch": torch.__version__}), flush=True)
    t0 = time.perf_counter()
    lib = build.build(["flash_attn"])["flash_attn"]
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    for ln in cs.ptxas_report(lib.with_suffix(".log").read_text()):
        print("  ptxas: " + ln, flush=True)
    pairs = getattr(K4, "HEAD_DIMS", None) or tuple((hd, hd) for hd in (64, 128))
    for dt in ("float32", "bfloat16"):
        for dk, dv in pairs:
            at = (dk,) if dk == dv else (dk, dv)
            print("  occupancy " + json.dumps({
                "dtype": dt, "dk": dk, "dv": dv,
                "fwd": K4.fwd_occupancy(getattr(torch, dt), *at),
                "bwd": K4.bwd_occupancy(getattr(torch, dt), *at)}), flush=True)
    only = {c for c in args.cases.split(",") if c}
    bad = []
    for i, (name, kw) in enumerate(cs.FLASH_CASES):
        if only and name not in only:
            continue
        try:
            row = cs.run_flash_case(torch, K4, ref, cs.make_flash_case(
                torch, "flash_" + name, seed=200 + i, **kw))
        except Exception as e:  # a case that cannot run is a row of its own
            row = {"case": "flash_" + name, "ok": False, "error": repr(e)[:400]}
        if not row["ok"]:
            bad.append(row["case"])
        print("  " + json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"failed": bad, "s": time.perf_counter() - t0}), flush=True)
    print(cs.smi(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
